"""Open-vocabulary segmentation: class-agnostic mask proposals named in a
SigLIP image-text space (counterpart of :mod:`gvl_tpu.perception.open_vocab`).

:class:`OpenVocabSamBackend` takes mask proposals (from SAM ViT prompted
with a point grid, :mod:`gvl_tpu_torch.models.sam_vit`, under an HF SAM and
SigLIP pair; or from the trained promptable segmenter prompted with its
training concepts), keeps them after mask NMS, crops each onto the SigLIP
canvas and scores it against the caller's text prompts, each embedded
under a template ensemble where one is set; the
:class:`LexiconPromptResolver` first maps unseen phrasings onto the
trained concepts through the trained retriever's text space.  It follows
the segmenter backend protocol (``(frames, concepts, frame_indices) →
results[frame][concept]``), so the tracker stacks on it unchanged.  The
towers and the proposer run on ``device``, the towers' attention through
the flash kernel (SAM's is plain PyTorch, as in JAX).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.perception.segmenter import BoundingBox, SegmentationMask

logger = logging.getLogger(__name__)

# HF SamProcessor normalization (ImageNet)
SAM_MEAN = (123.675, 116.28, 103.53)
SAM_STD = (58.395, 57.12, 57.375)

# default ensemble for the self-trained composite (the JAX module's)
TRAINED_PROMPT_TEMPLATES = ("{}", "sprite of {}", "a {}", "the {}")


class LexiconPromptResolver:
    """Resolve caller prompts to trained canonical concepts through the
    retrieval text-embedding space: embed the prompt (and its content
    words), take the cosine against every canonical concept's synonym pool,
    and substitute the canonical name when confident and clear of the
    runner-up by ``margin``; otherwise the raw prompt passes through."""

    _STOPWORDS = frozenset(
        "a an the of in on at and or one some this that you can".split())

    def __init__(self, embedder, lexicon: dict, threshold: float = 0.62,
                 word_threshold: float = 0.80, margin: float = 0.12):
        texts: list[str] = []
        owners: list[str] = []
        for canon, pool in lexicon.items():
            for t in dict.fromkeys((canon, *pool)):
                texts.append(t)
                owners.append(canon)
        self._exact = {t.lower(): o for t, o in zip(texts, owners)}
        emb = np.array(embedder.encode(texts), np.float32)
        emb /= np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-9)
        self._emb = emb
        self._owners = owners
        self._canonical = set(lexicon)
        self._embedder = embedder
        self.threshold = threshold
        self.word_threshold = word_threshold
        self.margin = margin
        self._cache: dict[str, tuple[str, float]] = {}

    @classmethod
    def from_trained(cls, retriever_dir: str = "outputs/retriever",
                     lexicon: Optional[dict] = None,
                     device: str | torch.device = "cuda", **kw) -> "LexiconPromptResolver":
        from gvl_tpu_torch.training.retriever_train import (
            ENTITY_SYNONYMS,
            TrainedTextEmbedder,
        )

        return cls(TrainedTextEmbedder.from_dir(retriever_dir, device=device),
                   lexicon or dict(ENTITY_SYNONYMS), **kw)

    def resolve(self, prompt: str) -> str:
        """Canonical concept when confident, the raw prompt otherwise."""
        return self.resolve_scored(prompt)[0]

    def resolve_scored(self, prompt: str) -> tuple[str, float]:
        """(resolved, confidence): the winning cosine, 1.0 for canonical or
        verbatim pool hits, 0.0 for passthrough."""
        if prompt in self._canonical:
            return prompt, 1.0
        if prompt not in self._cache:
            self._cache[prompt] = self._resolve_uncached(prompt)
        return self._cache[prompt]

    def resolve_set(self, prompts: Sequence[str]) -> list[str]:
        """Resolve a SET of prompts injectively: when two prompts resolve to
        the same canonical only the most confident keeps it and the rest
        pass through raw."""
        scored = [self.resolve_scored(p) for p in prompts]
        winner: dict[str, int] = {}
        for i, ((res, conf), raw) in enumerate(zip(scored, prompts)):
            if res == raw:
                continue
            if res in prompts:          # canonical asked for verbatim
                continue
            if res not in winner or conf > scored[winner[res]][1]:
                winner[res] = i
        return [res if (res == raw or winner.get(res) == i) else raw
                for i, ((res, _), raw) in enumerate(zip(scored, prompts))]

    def _resolve_uncached(self, prompt: str) -> tuple[str, float]:
        lowered = prompt.lower().strip()
        if lowered in self._exact:                 # verbatim pool entry
            return self._exact[lowered], 1.0
        words = [w for w in lowered.split()
                 if w not in self._STOPWORDS and len(w) >= 3]
        cands = list(dict.fromkeys([prompt, *words]))
        q = np.array(self._embedder.encode(cands), np.float32)
        q /= np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)
        sims = q @ self._emb.T                     # [cands, pool]
        # single words get the stricter threshold
        thresholds = [self.threshold] + [self.word_threshold] * len(words)
        per_concept: dict[str, float] = {}
        for i, thresh in enumerate(thresholds[: len(cands)]):
            for j, owner in enumerate(self._owners):
                s = float(sims[i, j])
                if s >= thresh:
                    per_concept[owner] = max(per_concept.get(owner, -1.0), s)
        if not per_concept:
            return prompt, 0.0
        ranked = sorted(per_concept.items(), key=lambda kv: -kv[1])
        best_c, best_s = ranked[0]
        # margin over the runner-up measured WITHOUT thresholds
        others = [float(sims[:, j].max())
                  for j, o in enumerate(self._owners) if o != best_c]
        if others and best_s - max(others) < self.margin:
            return prompt, 0.0
        return best_c, best_s


class OpenVocabSamBackend:
    """Mask proposals + SigLIP text scoring.

    ``propose_fn`` (frames → proposal masks ``[B, P, h, w]`` and scores
    ``[B, P]``) supplies the proposals; without one, ``sam_params`` (a
    :class:`~gvl_tpu_torch.models.sam_vit.SamViT` on its device; JAX's is
    its parameter tree) is prompted with a ``grid`` x ``grid`` point grid,
    one point a prompt, and each point's best of the three masks (by
    predicted IoU) is its proposal.  ``vision_backend`` is a uint8-in,
    pooled-out backend (:class:`~gvl_tpu_torch.perception.semantic.
    TorchSigLIPBackend` with 'cls' pooling); ``text_tower`` a text tower
    holding its weights (``text_params`` is unused: JAX's parameter tree)."""

    def __init__(self, sam_config, sam_params, vision_backend, text_tower, text_params,
                 tokenize, grid: int = 4, iou_threshold: float = 0.7,
                 score_threshold: float = 0.1, max_proposals: int = 16,
                 propose_fn=None, region_resolution: Optional[int] = None,
                 prompt_templates: Optional[Sequence[str]] = None,
                 prompt_resolver: Optional[LexiconPromptResolver] = None):
        from gvl_tpu_torch.perception.semantic import NaFlexConfig, RegionExtractor

        self.sam_config = sam_config
        self.sam_params = sam_params
        self.vision_backend = vision_backend
        self.text_tower = text_tower
        self.text_params = text_params
        self._tokenize = tokenize
        self.grid = grid
        self.iou_threshold = iou_threshold
        self.score_threshold = score_threshold
        self.max_proposals = max_proposals
        # CLIP-style prompt ensembling: each caller prompt is embedded under
        # every template and the normalized embeddings averaged
        self.prompt_templates = tuple(prompt_templates) if prompt_templates else None
        self.prompt_resolver = prompt_resolver
        self._text_cache: dict[tuple[str, ...], np.ndarray] = {}
        self._naflex = NaFlexConfig()
        if region_resolution:
            self._naflex.region_resolution = region_resolution
        self._extractor = RegionExtractor(self._naflex)
        if propose_fn is not None:
            self._proposals = propose_fn
        else:
            step = sam_config.image_size / grid
            axis = (np.arange(grid) + 0.5) * step
            self._points = np.stack(np.meshgrid(axis, axis, indexing="xy"), -1).reshape(
                -1, 1, 2).astype(np.float32)                  # [G², 1, 2]
            self._proposals = self._sam_proposals

    @torch.inference_mode()
    def _propose(self, pixels_u8: torch.Tensor, points: torch.Tensor,
                 labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        from gvl_tpu_torch.models.sam_vit import sam_predict

        device = pixels_u8.device
        pixels = (pixels_u8.float() - torch.tensor(SAM_MEAN, device=device)) \
            / torch.tensor(SAM_STD, device=device)
        masks, iou = sam_predict(self.sam_params, pixels, input_points=points,
                                 input_labels=labels, multimask_output=True)
        best = iou.argmax(-1)          # the best of the 3 multimask outputs a point
        mask = masks.gather(2, best[:, :, None, None, None].expand(
            -1, -1, 1, *masks.shape[3:]))[:, :, 0]
        return mask > 0.0, iou.max(-1).values

    def _sam_proposals(self, frames):
        """Point-grid SAM proposals → (masks ``[B, P, h', w']``, scores ``[B, P]``)."""
        from gvl_tpu_torch.runtime.native import resize_image

        size = self.sam_config.image_size
        device = next(self.sam_params.parameters()).device
        batch = np.stack([resize_image(np.ascontiguousarray(f), size, size)
                          for f in frames]).astype(np.uint8)
        n_pts = self._points.shape[0]
        points = np.broadcast_to(self._points[None], (len(frames), n_pts, 1, 2)).copy()
        labels = np.ones((len(frames), n_pts, 1), np.int64)
        masks, iou = self._propose(torch.from_numpy(batch).to(device),
                                   torch.from_numpy(points).to(device),
                                   torch.from_numpy(labels).to(device))
        return masks.cpu().numpy(), iou.float().cpu().numpy()

    @torch.inference_mode()
    def _embed_text(self, ids: np.ndarray) -> np.ndarray:
        device = next(self.text_tower.parameters()).device
        out = self.text_tower(torch.from_numpy(ids).to(device))["pooled"]
        out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-9)
        return out.float().cpu().numpy()

    # ------------------------------------------------------------ loading

    @classmethod
    def from_checkpoints(cls, sam_dir: str, siglip_vision_dir: str,
                         siglip_text_dir: Optional[str] = None,
                         device: str | torch.device = "cuda", **kw) -> "OpenVocabSamBackend":
        """From local HF checkpoint directories, every model on ``device``:
        SAM ViT proposals; the SigLIP vision tower behind the bf16 'cls'
        backend (SigLIP's image-text space is the MAP head's output); the
        text tower and its tokenizer (``transformers.AutoTokenizer``,
        imported here only) from ``siglip_text_dir`` or the vision
        directory."""
        from transformers import AutoTokenizer

        from gvl_tpu_torch.models.sam_vit import load_hf_sam, load_sam_vit
        from gvl_tpu_torch.models.siglip import (
            load_hf_siglip,
            load_hf_siglip_text,
            load_text_tower,
            load_tower,
        )
        from gvl_tpu_torch.perception.semantic import NaFlexConfig, TorchSigLIPBackend

        device = resolve_device(device)
        sam_config, sam_state = load_hf_sam(sam_dir)
        vision_config, vision_state = load_hf_siglip(siglip_vision_dir)
        nc = NaFlexConfig(pool_strategy="cls")
        vision_backend = TorchSigLIPBackend(
            load_tower(vision_config, vision_state, device), nc.dtype,
            image_mean=nc.image_mean, image_std=nc.image_std, pool_strategy=nc.pool_strategy)
        text_dir = siglip_text_dir or siglip_vision_dir
        text_config, text_state = load_hf_siglip_text(text_dir)
        tokenizer = AutoTokenizer.from_pretrained(text_dir)

        def tokenize(texts):
            return tokenizer(list(texts), padding="max_length", truncation=True,
                             max_length=text_config.max_position,
                             return_tensors="np")["input_ids"]

        return cls(sam_config, load_sam_vit(sam_config, sam_state, device), vision_backend,
                   load_text_tower(text_config, text_state, device), None, tokenize, **kw)

    @classmethod
    def from_trained_checkpoints(cls, segmenter_checkpoint: str, minisiglip_dir: str,
                                 proposal_concepts: Optional[Sequence[str]] = None,
                                 retriever_dir: Optional[str] = "auto",
                                 device: str | torch.device = "cuda",
                                 **kw) -> "OpenVocabSamBackend":
        """The fully offline composite: proposals from the trained
        promptable segmenter prompted with its training concepts
        (class-agnostic after mask NMS), named against the CALLER's text
        prompts in the mini-SigLIP image-text space; the lexicon resolver
        rides the trained retriever beside the segmenter checkpoint when
        ``retriever_dir`` is "auto" and one is there (otherwise the raw
        prompts go to the tower, as in JAX)."""
        from gvl_tpu_torch.perception.segmenter import SAMConfig as SegSAMConfig
        from gvl_tpu_torch.perception.segmenter import create_sam_segmenter
        from gvl_tpu_torch.perception.semantic import NaFlexConfig, TorchSigLIPBackend
        from gvl_tpu_torch.training.siglip_train import byte_tokenize, load_minisiglip

        device = resolve_device(device)
        model, vision_cfg, text_cfg = load_minisiglip(minisiglip_dir, device)
        nc = NaFlexConfig(pool_strategy="cls")
        vision_backend = TorchSigLIPBackend(model.vision, nc.dtype, image_mean=nc.image_mean,
                                            image_std=nc.image_std, pool_strategy="cls")
        seg = create_sam_segmenter(SegSAMConfig(), use_model=True,
                                   checkpoint=segmenter_checkpoint, device=device)
        seg_backend = seg.backend
        if proposal_concepts is None:
            from gvl_tpu_torch.training.segmenter_train import CONCEPTS

            proposal_concepts = CONCEPTS
        proposal_concepts = list(proposal_concepts)

        def propose(frames):
            out, n_real = seg_backend.submit(frames, proposal_concepts)
            masks = out["mask"].cpu().numpy().astype(bool)[:n_real]
            scores = out["scores"].float().cpu().numpy()[:n_real]
            b, c, q = scores.shape
            return (masks.reshape(b, c * q, *masks.shape[3:]), scores.reshape(b, c * q))

        def tokenize(texts):
            return byte_tokenize(list(texts), text_cfg.max_position)

        kw.setdefault("prompt_templates", TRAINED_PROMPT_TEMPLATES)
        if retriever_dir == "auto":
            cand = Path(segmenter_checkpoint).resolve().parent / "retriever"
            retriever_dir = str(cand) if (cand / "retriever_config.json").exists() else None
        if retriever_dir and "prompt_resolver" not in kw:
            kw["prompt_resolver"] = LexiconPromptResolver.from_trained(retriever_dir,
                                                                       device=device)
        return cls(None, None, vision_backend, model.text, None, tokenize,
                   propose_fn=propose, region_resolution=vision_cfg.image_size, **kw)

    # ----------------------------------------------------------- internals

    def _concept_embeddings(self, concepts: Sequence[str]) -> np.ndarray:
        key = tuple(concepts)
        if key not in self._text_cache:
            if self.prompt_resolver is not None:
                # lexicon resolution before templating, injective over the
                # set (the cache stays keyed on the caller's raw prompts)
                concepts = self.prompt_resolver.resolve_set(list(concepts))
            if self.prompt_templates:
                texts = [t.format(c) for c in concepts for t in self.prompt_templates]
                emb = self._embed_text(np.asarray(self._tokenize(texts), np.int32))
                emb = emb.reshape(len(concepts), len(self.prompt_templates), -1).mean(1)
                emb /= np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-9)
                self._text_cache[key] = emb
            else:
                self._text_cache[key] = self._embed_text(
                    np.asarray(self._tokenize(list(concepts)), np.int32))
        return self._text_cache[key]

    def _nms(self, masks: np.ndarray, scores: np.ndarray):
        """Score-ordered mask NMS → kept indices."""
        order = np.argsort(-scores)
        kept: list[int] = []
        for idx in order:
            m = masks[idx]
            if not m.any():
                continue
            dup = any(
                (m & masks[j]).sum() / max((m | masks[j]).sum(), 1) > self.iou_threshold
                for j in kept
            )
            if not dup:
                kept.append(int(idx))
            if len(kept) >= self.max_proposals:
                break
        return kept

    # ------------------------------------------------------------ protocol

    def __call__(self, frames, concepts, frame_indices):
        from gvl_tpu_torch.runtime.native import resize_mask

        prop_masks, prop_iou = self._proposals(frames)
        prop_masks = np.asarray(prop_masks)     # [B, P, h', w'] bool
        prop_iou = np.asarray(prop_iou)         # [B, P]
        text_emb = self._concept_embeddings(concepts)   # [C, D]

        results = []
        for fi, frame in enumerate(frames):
            h, w = frame.shape[:2]
            kept = self._nms(prop_masks[fi], prop_iou[fi])
            regions, full_masks = [], []
            for j in kept:
                mask = resize_mask(prop_masks[fi, j], h, w)
                ys, xs = np.where(mask)
                if len(xs) == 0:
                    continue
                regions.append(frame[ys.min():ys.max() + 1, xs.min():xs.max() + 1])
                full_masks.append((mask, float(prop_iou[fi, j]),
                                   (float(xs.min()), float(ys.min()),
                                    float(xs.max()), float(ys.max()))))
            per_frame = [[] for _ in concepts]
            if regions:
                res = self._naflex.region_resolution
                prepared = [self._extractor.prepare(r, res)[0] for r in regions]
                n = len(prepared)
                # bucket-pad, as the JAX class does to compile once a bucket
                bucket = next((b for b in (1, 4, 8, self.max_proposals) if n <= b), n)
                prepared += [np.zeros_like(prepared[0])] * (bucket - n)
                _, pooled = self.vision_backend(np.stack(prepared))
                pooled = pooled[:n]
                emb = pooled / np.maximum(np.linalg.norm(pooled, axis=-1, keepdims=True), 1e-9)
                scores = emb @ text_emb.T               # [R, C]
                for r, (mask, _, bbox) in enumerate(full_masks):
                    ci = int(np.argmax(scores[r]))
                    if scores[r, ci] < self.score_threshold:
                        continue
                    per_frame[ci].append({"mask": SegmentationMask(
                        mask=mask, confidence=float(scores[r, ci]),
                        bbox=BoundingBox(*bbox), area_pixels=int(mask.sum()))})
            results.append(per_frame)
        return results


def create_open_vocab_segmenter(sam_dir: str, siglip_vision_dir: str,
                                siglip_text_dir: Optional[str] = None, config=None,
                                device: str | torch.device = "cuda", **kw):
    """SAMConceptSegmenter (tracking included) over the HF composite
    (:meth:`OpenVocabSamBackend.from_checkpoints`)."""
    from gvl_tpu_torch.perception.segmenter import SAMConceptSegmenter, SAMConfig

    backend = OpenVocabSamBackend.from_checkpoints(
        sam_dir, siglip_vision_dir, siglip_text_dir, device=device, **kw)
    return SAMConceptSegmenter(config or SAMConfig(), backend=backend)


def create_trained_open_vocab_segmenter(segmenter_checkpoint: str, minisiglip_dir: str,
                                        config=None, device: str | torch.device = "cuda",
                                        **kw):
    """SAMConceptSegmenter (tracking included) over the self-trained
    composite."""
    from gvl_tpu_torch.perception.segmenter import SAMConceptSegmenter, SAMConfig

    backend = OpenVocabSamBackend.from_trained_checkpoints(
        segmenter_checkpoint, minisiglip_dir, device=device, **kw)
    return SAMConceptSegmenter(config or SAMConfig(), backend=backend)
