"""Projector training: generative alignment against a frozen LLM, in
PyTorch (counterpart of :mod:`gvl_tpu.training.projector_train`).

Project an encoder embedding, prepend it to the token embeddings of a
text context, teacher-force the frozen LLM (``embed_only`` and
``inputs_embeds``; its attention through the flash kernel's forward on the
card) and take cross-entropy on the target span: gradients flow through
the frozen LLM into the projector only.  Without an LLM: in-batch
contrastive alignment against the hashing text space (``cosine``), or the
norm calibration toward sqrt(llm_dim) (``norm``).  Samples are batched per
modality; each modality's head has its own optimizer state.  Writes the
reference-layout ``projector_weights.pt`` at the best epoch loss, which
:meth:`~gvl_tpu_torch.models.projector.ProjectorBank.load_weights` reads.
``mesh=`` is kept and read nowhere, as in JAX (ROADMAP C17).
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.agent.config import ReasoningCoreConfig
from gvl_tpu_torch.models.projector import MODALITY_DIMS, ProjectorBank
from gvl_tpu_torch.training import optim
from gvl_tpu_torch.training.qa_lm_train import masked_ce

logger = logging.getLogger(__name__)


@dataclass
class ProjectorTrainingConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    epochs: int = 3
    batch_size: int = 8
    warmup_steps: int = 20
    max_target_tokens: int = 32
    llm_dim: int = 4096
    seed: int = 0
    output_path: str = "outputs/projector_weights.pt"
    # no-LLM objective: "cosine" (in-batch contrastive alignment against
    # the hashing text space) or "norm" (calibration only)
    objective: str = "cosine"
    text_dim: int = 256
    temperature: float = 0.07


class MultimodalProjectorDataset:
    """Pairs saved embeddings with nearby-event text contexts.

    Reads ``*_embeddings.npz`` plus the sibling ``*_features.json`` written
    by ``scripts/extract_features.py``; each embedding is paired with the
    timeline text closest to its timestamp.
    """

    MODALITY_KEYS = {"siglip": "siglip", "videomae": "videomae",
                     "audio": "wav2vec2"}

    def __init__(self, features_dir: str | Path):
        self.features_dir = Path(features_dir)
        self.samples: list[dict] = []
        self._load()

    def _load(self) -> None:
        for emb_path in sorted(self.features_dir.glob("*_embeddings.npz")):
            stem = emb_path.name.removesuffix("_embeddings.npz")
            texts = self._load_texts(stem)
            with np.load(emb_path) as z:
                for modality, key in self.MODALITY_KEYS.items():
                    if key not in z or len(z[key]) == 0:
                        continue
                    ts = z[f"{key}_ts"] if f"{key}_ts" in z else np.arange(len(z[key]))
                    for i, emb in enumerate(z[key]):
                        t = float(ts[i]) if i < len(ts) else 0.0
                        self.samples.append({
                            "modality": modality,
                            "embedding": np.asarray(emb, np.float32),
                            "text": self._nearest_text(texts, t),
                            "timestamp": t,
                        })
        logger.info("projector dataset: %d samples from %s",
                    len(self.samples), self.features_dir)

    def _load_texts(self, stem: str) -> list[tuple[float, str]]:
        feats = self.features_dir / f"{stem}_features.json"
        out: list[tuple[float, str]] = []
        if feats.exists():
            doc = json.loads(feats.read_text())
            for row in doc.get("ocr", []):
                for text in row.get("texts", []):
                    out.append((float(row.get("timestamp", 0.0)), text))
            for row in doc.get("transcription", []):
                out.append((float(row.get("start", 0.0)), row.get("text", "")))
            for ent in doc.get("entities", []):
                out.append((0.0, f"{ent.get('concept', 'entity')} visible"))
        return out or [(0.0, "gameplay footage")]

    @staticmethod
    def _nearest_text(texts: list[tuple[float, str]], t: float) -> str:
        return min(texts, key=lambda pair: abs(pair[0] - t))[1]

    def batches(self, modality: str, batch_size: int,
                rng: np.random.Generator) -> Iterator[dict]:
        rows = [s for s in self.samples if s["modality"] == modality]
        if not rows:
            return
        order = rng.permutation(len(rows))
        for start in range(0, len(rows) - batch_size + 1, batch_size):
            chunk = [rows[i] for i in order[start: start + batch_size]]
            yield {
                "embedding": np.stack([c["embedding"] for c in chunk]),
                "text": [c["text"] for c in chunk],
            }

    def __len__(self) -> int:
        return len(self.samples)

    def modality_dims(self) -> dict[str, int]:
        """Observed embedding width per modality (the projector heads'
        input widths)."""
        dims: dict[str, int] = {}
        for s in self.samples:
            dims.setdefault(s["modality"], int(s["embedding"].shape[-1]))
        return dims


def text_projection_matrix(llm_dim: int, text_dim: int) -> np.ndarray:
    """The fixed seeded map LLM space -> text space, shared by the cosine
    objective and :func:`evaluate_retrieval` (never trained)."""
    rng = np.random.default_rng(42)
    mat = rng.standard_normal((llm_dim, text_dim)).astype(np.float32)
    return (mat / np.sqrt(llm_dim)).astype(np.float32)


_PROJECT_METHOD = {"siglip": "project_region",
                   "videomae": "project_videomae",
                   "audio": "project_audio"}


def evaluate_retrieval(
    bank,
    dataset: MultimodalProjectorDataset,
    text_dim: int = 256,
    llm_dim: int = 4096,
    max_rows: int = 512,
    ks: tuple[int, ...] = (1, 5),
) -> dict:
    """Projected embedding -> nearest timeline texts: top-k accuracy per
    modality against the unique texts of that modality (chance k / #unique)."""
    from gvl_tpu_torch.agent.retriever import HashingTextEmbedder

    embedder = HashingTextEmbedder(text_dim)
    proj_map = text_projection_matrix(llm_dim, text_dim)
    out: dict[str, dict] = {}
    for modality, method in _PROJECT_METHOD.items():
        rows = [s for s in dataset.samples
                if s["modality"] == modality][:max_rows]
        if len(rows) < 4:
            continue
        texts = [r["text"] for r in rows]
        uniq = sorted(set(texts))
        if len(uniq) < 2:
            continue
        cand = embedder.encode(uniq)                     # [U, d], L2
        own = np.asarray([uniq.index(t) for t in texts])
        embs = np.stack([r["embedding"] for r in rows])
        projected = np.asarray(getattr(bank, method)(embs), np.float32)
        mapped = projected @ proj_map
        mapped /= np.maximum(
            np.linalg.norm(mapped, axis=-1, keepdims=True), 1e-8)
        sims = mapped @ cand.T                           # [N, U]
        ranks = np.argsort(-sims, axis=1)
        metrics = {"rows": len(rows), "unique_texts": len(uniq)}
        for k in ks:
            hits = np.any(ranks[:, :k] == own[:, None], axis=1)
            metrics[f"top{k}"] = float(hits.mean())
            metrics[f"chance_top{k}"] = min(k / len(uniq), 1.0)
        out[modality] = metrics
    return out


class ProjectorTrainer:
    """Generative-alignment training loop over a frozen LLM.

    ``llm`` is ``(Qwen3Config, state_dict, tokenize)`` or None; without it
    the ``cosine`` or ``norm`` objective trains.  The bank lies on
    ``device`` (:attr:`bank`); the frozen LLM is built there from the state
    dict's tensors (shared, not copied, when already there) and never
    changes.
    """

    def __init__(
        self,
        config: Optional[ProjectorTrainingConfig] = None,
        reasoning_config: Optional[ReasoningCoreConfig] = None,
        llm=None,
        mesh=None,
        device="cuda",
    ):
        self.mesh = mesh      # stored and not read, as JAX's (ROADMAP C17)
        self.config = config or ProjectorTrainingConfig()
        self.device = resolve_device(device)
        self.reasoning_config = reasoning_config or ReasoningCoreConfig(
            llm_hidden_dim=self.config.llm_dim)
        self.bank = ProjectorBank(self.reasoning_config, device=self.device).init(
            self.config.seed)
        self.llm, self.llm_model = llm, None
        if llm is not None:
            from gvl_tpu_torch.models.qwen3 import load_model

            llm_config, state, _ = llm
            self.llm_model = load_model(llm_config, state, self.device).requires_grad_(False)
        self.schedule = optim.warmup_cosine_decay_schedule(
            0.0, self.config.learning_rate, self.config.warmup_steps, 1000)
        self._text_embedder = None

    # ----------------------------------------------------------- objectives

    def _loss(self, head, emb: torch.Tensor, aux1: torch.Tensor,
              aux2: torch.Tensor) -> torch.Tensor:
        target_dim = self.reasoning_config.llm_hidden_dim
        if self.llm_model is not None:
            # aux1: token ids [B, T]; aux2: target mask [B, T].  The
            # projected token shifts the text right by one: position t
            # predicts token t.
            projected = head(emb)[:, None, :]
            token_embeds = self.llm_model.embed_only(aux1)
            inputs = torch.cat([projected.to(token_embeds.dtype), token_embeds], dim=1)
            logits, _ = self.llm_model(inputs_embeds=inputs)
            return masked_ce(logits[:, :-1], aux1, aux2)
        if self.config.objective == "cosine":
            # aux1: the texts' hashing embeddings [B, text_dim]; symmetric
            # in-batch InfoNCE, equal texts are not each other's negatives
            proj_map = torch.from_numpy(text_projection_matrix(
                target_dim, self.config.text_dim)).to(emb.device)
            mapped = head(emb) @ proj_map
            mapped = mapped / torch.clamp(mapped.norm(dim=-1, keepdim=True), min=1e-8)
            logits = mapped @ aux1.T / self.config.temperature
            same = (aux1 @ aux1.T) > 0.999
            eye = torch.eye(len(logits), dtype=torch.bool, device=emb.device)
            logits = logits.masked_fill(same & ~eye, -1e30)
            labels = torch.arange(len(logits), device=emb.device)
            return (F.cross_entropy(logits, labels, reduction="none")
                    + F.cross_entropy(logits.T, labels, reduction="none")).mean() / 2.0
        norms = head(emb).norm(dim=-1)
        return torch.mean((norms - float(np.sqrt(float(target_dim)))) ** 2)

    def _tokenize_batch(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """(token_ids [B, T], target_mask [B, T]) padded to max_target."""
        max_len = self.config.max_target_tokens
        if self.llm is not None:
            _, _, tokenize = self.llm
        else:
            from gvl_tpu_torch.models.sam import hash_tokenize

            def tokenize(text):
                return hash_tokenize(text, 512, max_len).tolist()
        ids = np.zeros((len(texts), max_len), np.int32)
        mask = np.zeros((len(texts), max_len), np.float32)
        for i, text in enumerate(texts):
            toks = list(tokenize(text))[:max_len]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1.0
        return ids, mask

    def _aux(self, texts: list[str]) -> tuple[torch.Tensor, torch.Tensor]:
        if self.llm is None and self.config.objective == "cosine":
            from gvl_tpu_torch.agent.retriever import HashingTextEmbedder

            if self._text_embedder is None:
                self._text_embedder = HashingTextEmbedder(self.config.text_dim)
            return (torch.from_numpy(self._text_embedder.encode(texts)).to(self.device),
                    torch.zeros(len(texts), device=self.device))
        ids, mask = self._tokenize_batch(texts)
        return (torch.from_numpy(ids).long().to(self.device),
                torch.from_numpy(mask).to(self.device))

    # -------------------------------------------------------------- train

    def train(self, dataset: MultimodalProjectorDataset) -> dict:
        rng = np.random.default_rng(self.config.seed)
        history: dict[str, list[float]] = {}
        best_loss = float("inf")
        heads = self.bank.heads
        for head in heads.values():
            head.requires_grad_(True)
        opts = {m: optim.AdamW(heads[m].parameters(), self.schedule,
                               weight_decay=self.config.weight_decay, clip=self.config.grad_clip)
                for m in MODALITY_DIMS}
        for epoch in range(self.config.epochs):
            epoch_losses = []
            for modality in ("siglip", "videomae", "audio"):
                for batch in dataset.batches(modality, self.config.batch_size, rng):
                    emb = torch.from_numpy(batch["embedding"]).to(self.device)
                    aux1, aux2 = self._aux(batch["text"])
                    loss = optim.train_step(heads[modality], opts[modality],
                                            lambda head: self._loss(head, emb, aux1, aux2))
                    loss = float(loss)
                    epoch_losses.append(loss)
                    history.setdefault(modality, []).append(loss)
            mean_loss = float(np.mean(epoch_losses)) if epoch_losses else 0.0
            logger.info("epoch %d: mean loss %.4f", epoch, mean_loss)
            if mean_loss < best_loss and epoch_losses:
                best_loss = mean_loss
                self.bank.save_weights(self.config.output_path)
                logger.info("checkpointed best (loss %.4f)", best_loss)
        return {"best_loss": best_loss, "history": history}
