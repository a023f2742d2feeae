"""LoRA supervised fine-tuning of the reasoning core, in PyTorch.

Counterpart of :mod:`gvl_tpu.training.lora_train`: chat-format Q&A pairs,
the prompt tokens masked out of the loss, r=32/alpha=64 on all seven
projection targets, lr 2e-5, the mean of 8 gradients per update.  Only the
``lora_a``/``lora_b`` pairs take gradients; every other tensor keeps its
bits.  Adapters are saved in the JAX package's npz layout (the parameter
paths of its tree), so either package merges them.  ``mesh=`` is taken
and kept as JAX's trainer keeps it, and read nowhere (ROADMAP C17): the
data-parallel step lives in ``gvl_tpu_torch.entry.dryrun_multichip``, as
in JAX.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.qwen3 import Qwen3Config, _jax_key
from gvl_tpu_torch.training import optim
from gvl_tpu_torch.training.qa_lm_train import masked_ce, training_model

logger = logging.getLogger(__name__)

LORA_NAMES = ("lora_a", "lora_b")


@dataclass
class LoraTrainingConfig:
    lora_rank: int = 32
    lora_alpha: float = 64.0
    learning_rate: float = 2e-5
    grad_accum_steps: int = 8
    epochs: int = 3
    batch_size: int = 1
    max_seq_len: int = 4096
    grad_clip: float = 1.0
    seed: int = 0
    output_dir: str = "outputs/lora_adapter"
    save_steps: int = 50
    save_total_limit: int = 3
    targets: tuple[str, ...] = (
        "q_proj", "k_proj", "v_proj", "o_proj",
        "gate_proj", "up_proj", "down_proj",
    )


def load_chat_training_data(path: str | Path) -> list[dict]:
    """Validate chat-format pairs: each sample has user+assistant turns."""
    doc = json.loads(Path(path).read_text())
    rows = doc if isinstance(doc, list) else doc.get("data", [])
    out = []
    for i, row in enumerate(rows):
        messages = row.get("messages", row.get("conversations", []))
        roles = [m.get("role", m.get("from")) for m in messages]
        if "user" not in roles or "assistant" not in roles:
            logger.warning("sample %d missing user/assistant turns; skipped", i)
            continue
        out.append({"messages": [
            {"role": m.get("role", m.get("from")),
             "content": m.get("content", m.get("value", ""))}
            for m in messages
        ]})
    logger.info("loaded %d valid chat samples from %s", len(out), path)
    return out


def lora_mask(params: dict) -> dict[str, bool]:
    """Parameter name -> whether it is a ``lora_a``/``lora_b`` tensor."""
    return {name: name.rsplit(".", 1)[-1] in LORA_NAMES for name in params}


def adapter_arrays(state_dict: dict, config: Qwen3Config) -> dict[str, np.ndarray]:
    """The LoRA pairs of a state dict under the JAX parameter paths
    (``layers_3/self_attn/q_proj/lora_a``), as f32 numpy arrays."""
    return {_jax_key(name, config): t.detach().float().cpu().numpy()
            for name, t in state_dict.items() if lora_mask({name: t})[name]}


class LoraTrainer:
    """SFT loop updating only the LoRA pairs of a frozen base model.

    ``model_config`` must have ``lora_rank > 0``; ``params`` is its state
    dict (the pairs included); ``tokenize`` maps text to token ids.  The
    model is built on ``device`` from f32 copies of ``params``;
    :attr:`params` reads the current state dict.
    """

    def __init__(
        self,
        model_config: Qwen3Config,
        params: dict[str, torch.Tensor],
        tokenize: Callable[[str], list[int]],
        config: Optional[LoraTrainingConfig] = None,
        mesh=None,
        device="cuda",
    ):
        if model_config.lora_rank <= 0:
            raise ValueError(
                "model must be built with lora_rank > 0 for LoRA training"
            )
        self.model_config = model_config
        self.mesh = mesh      # stored and not read, as JAX's (ROADMAP C17)
        self.device = resolve_device(device)
        self.model = training_model(model_config, params, self.device)
        self.tokenize = tokenize
        self.config = config or LoraTrainingConfig()
        mask = lora_mask(dict(self.model.named_parameters()))
        for name, p in self.model.named_parameters():
            p.requires_grad_(mask[name])

        self.optimizer = optim.AdamW(
            [p for p in self.model.parameters() if p.requires_grad],
            optim.cosine_decay_schedule(self.config.learning_rate, 1000),
            clip=self.config.grad_clip, every_k=self.config.grad_accum_steps)
        self._global_step = 0
        self._checkpoints: list[Path] = []

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return {name: t.detach() for name, t in self.model.state_dict().items()}

    # ------------------------------------------------------------ batching

    def encode_sample(self, sample: dict) -> Optional[dict]:
        """Tokenize a chat sample; labels = -100 outside assistant spans."""
        ids: list[int] = []
        labels: list[int] = []
        for message in sample["messages"]:
            text = f"<|{message['role']}|>{message['content']}\n"
            toks = list(self.tokenize(text))
            ids.extend(toks)
            if message["role"] == "assistant":
                labels.extend(toks)
            else:
                labels.extend([-100] * len(toks))
        if not ids:
            return None
        max_len = self.config.max_seq_len
        ids, labels = ids[:max_len], labels[:max_len]
        pad = max_len - len(ids)
        return {
            "input_ids": np.asarray(ids + [0] * pad, np.int32),
            "labels": np.asarray(labels + [-100] * pad, np.int32),
        }

    def _loss(self, model, input_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits, _ = model(input_ids)
        targets = labels[:, 1:]
        mask = (targets != -100).float()
        return masked_ce(logits[:, :-1], torch.clamp(targets, min=0), mask)

    # --------------------------------------------------------------- train

    def dry_run(self, data: list[dict]) -> dict:
        """Validate data + tokenization without touching the model."""
        encoded = [self.encode_sample(s) for s in data]
        valid = [e for e in encoded if e is not None]
        lengths = [int((e["labels"] != -100).sum()) for e in valid]
        return {
            "num_samples": len(data),
            "num_valid": len(valid),
            "mean_target_tokens": float(np.mean(lengths)) if lengths else 0.0,
        }

    def train(self, data: list[dict]) -> dict:
        rng = np.random.default_rng(self.config.seed)
        losses = []
        encoded = [e for e in (self.encode_sample(s) for s in data) if e]
        if not encoded:
            return {"steps": 0, "final_loss": None}
        for epoch in range(self.config.epochs):
            order = rng.permutation(len(encoded))
            for start in range(0, len(encoded), self.config.batch_size):
                chunk = [encoded[i] for i in
                         order[start: start + self.config.batch_size]]
                input_ids, labels = (
                    torch.from_numpy(np.stack([c[key] for c in chunk])).to(self.device)
                    for key in ("input_ids", "labels"))
                loss = optim.train_step(self.model, self.optimizer,
                                        lambda m: self._loss(m, input_ids, labels))
                losses.append(float(loss))
                self._global_step += 1
                if self._global_step % self.config.save_steps == 0:
                    self.save_adapter()
            logger.info("epoch %d: loss %.4f", epoch,
                        float(np.mean(losses[-len(encoded):])))
        self.save_adapter(final=True)
        return {"steps": self._global_step, "final_loss": losses[-1]}

    # ---------------------------------------------------------- checkpoint

    def extract_adapter(self) -> dict[str, np.ndarray]:
        """Flat {JAX path: array} of only the LoRA params."""
        return adapter_arrays(self.model.state_dict(), self.model_config)

    def save_adapter(self, final: bool = False) -> Path:
        out_dir = Path(self.config.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        name = "adapter_final.npz" if final else (
            f"adapter_step{self._global_step:06d}.npz")
        path = out_dir / name
        np.savez_compressed(path, **self.extract_adapter())
        (out_dir / "adapter_config.json").write_text(json.dumps({
            "lora_rank": self.model_config.lora_rank,
            "lora_alpha": self.model_config.lora_alpha,
            "targets": list(self.model_config.lora_targets),
        }, indent=2))
        if not final:
            self._checkpoints.append(path)
            while len(self._checkpoints) > self.config.save_total_limit:
                victim = self._checkpoints.pop(0)
                victim.unlink(missing_ok=True)
        return path

    @torch.no_grad()
    def load_adapter(self, path: str | Path) -> None:
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        for name, p in self.model.named_parameters():
            key = _jax_key(name, self.model_config)
            if key in flat:
                p.copy_(torch.from_numpy(flat[key]))
