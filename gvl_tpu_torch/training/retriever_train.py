"""The self-trained retrieval text embedder, inference only (counterpart of
the inference half of :mod:`gvl_tpu.training.retriever_train`).

A byte-level :class:`~gvl_tpu_torch.models.siglip.SigLIPTextTower` (4
layers, hidden 256, 64 positions in ``outputs/retriever``) embeds timeline
event descriptions and queries; its attention goes through the flash
kernel.  Training and the paraphrase vocabulary stay in the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.convert import siglip_text_params_from_jax
from gvl_tpu_torch.models.siglip import SigLIPTextConfig, SigLIPTextTower
from gvl_tpu_torch.nn.layers import load_module
from gvl_tpu_torch.utils.checkpoints import load_flat_npz


def byte_tokenize(texts: Sequence[str], max_position: int = 32) -> np.ndarray:
    """Lowercased UTF-8 bytes, 0-padded on the LEFT to ``max_position``
    (``gvl_tpu.training.siglip_train.byte_tokenize``): the pooled output is
    taken at the last position, so text is right-aligned."""
    out = np.zeros((len(texts), max_position), np.int32)
    for i, text in enumerate(texts):
        ids = list(text.lower().encode("utf-8"))[: max_position]
        out[i, max_position - len(ids):] = ids
    return out


def tokenize(texts: Sequence[str], max_position: int = 64) -> np.ndarray:
    return byte_tokenize(texts, max_position)


def load_retriever(ckpt_dir) -> tuple[SigLIPTextConfig, dict]:
    """(config, JAX parameter tree as numpy) of a trained retriever dir."""
    ckpt = Path(ckpt_dir)
    raw = json.loads((ckpt / "retriever_config.json").read_text())
    cfg = SigLIPTextConfig(**{
        k: v for k, v in raw["model"].items()
        if k in SigLIPTextConfig.__dataclass_fields__})
    return cfg, load_flat_npz(ckpt / "params.npz")


def is_trained_retriever_checkpoint(path) -> bool:
    return bool(path) and (Path(path) / "retriever_config.json").exists()


class TrainedTextEmbedder:
    """TextEmbedder protocol over the trained tower: L2-normalised pooled
    outputs, f32 numpy ``[N, projection_size]``."""

    def __init__(self, model_cfg: SigLIPTextConfig, params: dict,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = model_cfg
        self.dim = model_cfg.projection_size
        with torch.device("meta"):
            tower = SigLIPTextTower(model_cfg)
        state = params if "token_embed.weight" in params else \
            siglip_text_params_from_jax(params, model_cfg.num_layers)
        self.tower = load_module(tower, state, self.device)

    @torch.inference_mode()
    def embed_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Token ids ``[N, T]`` on the tower's device → unit embeddings."""
        z = self.tower(ids)["pooled"]
        return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if not len(texts):
            return np.zeros((0, self.dim), np.float32)
        ids = torch.from_numpy(tokenize(list(texts), self.config.max_position))
        return self.embed_ids(ids.to(self.device)).float().cpu().numpy()

    @classmethod
    def from_dir(cls, ckpt_dir, device: str | torch.device = "cuda") -> "TrainedTextEmbedder":
        cfg, params = load_retriever(ckpt_dir)
        return cls(cfg, params, device=device)
