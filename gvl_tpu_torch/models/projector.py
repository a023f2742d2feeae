"""Modality projectors: encoder embedding spaces -> LLM hidden space (the
port's :class:`ProjectorBank`, counterpart of
:mod:`gvl_tpu.models.projector`).

One 2-layer MLP per modality (``Linear(enc -> llm) -> GELU (erf) ->
Linear(llm -> llm)``) bridging SigLIP (1152), VideoMAE (768), legacy video
(1408) and audio (1024) embeddings into the reasoning core's 4096-wide
space.  Weights load from the native ``.npz`` layout
(``{modality}/{fc_in,fc_out}/{kernel,bias}``, kernels ``[in, out]``), from
the ``.pt`` layout of ``outputs/projector_weights.pt`` (per-modality
``net.0`` / ``net.2`` state dicts) or from the JAX package's parameters
(:func:`gvl_tpu_torch.models.convert.projector_params_from_jax`).  A fresh
bank draws its heads from a seeded generator with the JAX package's
initialisers (its numbers differ from Flax's draws).  The JAX bank pads
row counts to buckets for its compiled programs; here rows go through as
they are.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.agent.config import ReasoningCoreConfig

logger = logging.getLogger(__name__)

# modality name -> config attribute holding the encoder dim
MODALITY_DIMS = {
    "siglip": "siglip_dim",
    "videomae": "videomae_dim",
    "video": "internvideo_dim",   # legacy InternVideo path
    "audio": "audiomae_dim",
}
_LAYERS = ("fc_in", "fc_out")


class MultiModalProjector(nn.Module):
    """Linear -> GELU (erf) -> Linear into the LLM hidden space."""

    def __init__(self, in_dim: int, llm_dim: int = 4096):
        super().__init__()
        self.fc_in = nn.Linear(in_dim, llm_dim)
        self.fc_out = nn.Linear(llm_dim, llm_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_out(nn.functional.gelu(self.fc_in(x)))


class ProjectorBank:
    """Per-modality projectors on ``device``.

    >>> bank = ProjectorBank(ReasoningCoreConfig(), device="cpu").init()
    >>> tokens = bank.project_region(np.random.randn(5, 1152))  # (5, 4096)
    """

    def __init__(self, config: Optional[ReasoningCoreConfig] = None,
                 device: str | torch.device = "cuda"):
        self.config = config or ReasoningCoreConfig()
        self.device = resolve_device(device)
        self.heads: dict[str, MultiModalProjector] = {}

    def _dim(self, name: str) -> int:
        return int(getattr(self.config, MODALITY_DIMS[name]))

    # ---------------------------------------------------------------- init

    def init(self, seed: int = 0) -> "ProjectorBank":
        for name in MODALITY_DIMS:
            self.heads[name] = self._init_head(name, seed)
        return self

    def _init_head(self, name: str, seed: int = 0) -> MultiModalProjector:
        from gvl_tpu_torch.nn.layers import init_state, load_module

        gen = torch.Generator(device=self.device).manual_seed(
            seed + list(MODALITY_DIMS).index(name))
        with torch.device("meta"):
            head = MultiModalProjector(self._dim(name), self.config.llm_hidden_dim)
        return load_module(head, init_state(head, gen, self.device), self.device)

    def load_params(self, params: dict[str, dict[str, torch.Tensor]]) -> None:
        """Heads from per-modality state dicts (``fc_in.weight`` ``[out, in]``
        and so on).  A head whose input width is not the configured
        modality width is drawn afresh (seed 0, as JAX draws it from
        ``PRNGKey(0)``), with a warning."""
        from gvl_tpu_torch.nn.layers import load_module

        for name, state in params.items():
            if name not in MODALITY_DIMS:
                continue
            got, want = int(state["fc_in.weight"].shape[1]), self._dim(name)
            if got != want:
                logger.warning(
                    "projector head '%s' has input dim %d but the configured "
                    "modality dim is %d — keeping the initialized head", name, got, want)
                self.heads[name] = self._init_head(name)
                continue
            with torch.device("meta"):
                head = MultiModalProjector(got, int(state["fc_in.weight"].shape[0]))
            self.heads[name] = load_module(
                head, {k: v.float() for k, v in state.items()}, self.device)

    # ------------------------------------------------------------- project

    @torch.inference_mode()
    def project(self, modality: str, embeddings) -> np.ndarray:
        """Project ``[N, enc_dim]`` (or ``[enc_dim]``) to ``[N, llm_dim]``."""
        if modality not in self.heads:
            raise KeyError(f"unknown modality {modality!r}; bank has {list(self.heads)}")
        x = torch.as_tensor(np.asarray(embeddings, np.float32), device=self.device)
        return self.heads[modality](x).cpu().numpy()

    def project_region(self, embeddings) -> np.ndarray:
        return self.project("siglip", embeddings)

    def project_videomae(self, embeddings) -> np.ndarray:
        return self.project("videomae", embeddings)

    def project_video(self, embeddings) -> np.ndarray:
        return self.project("video", embeddings)

    def project_audio(self, embeddings) -> np.ndarray:
        return self.project("audio", embeddings)

    # ------------------------------------------------------------- weights

    def load_weights(self, path: str | Path) -> None:
        """Load the native ``.npz`` or the ``.pt`` layout."""
        path = Path(path)
        if path.suffix == ".npz":
            from gvl_tpu_torch.models.convert import projector_params_from_jax
            from gvl_tpu_torch.utils.checkpoints import load_flat_npz

            params = projector_params_from_jax(load_flat_npz(path))
        else:
            blob = torch.load(path, map_location="cpu", weights_only=True)
            params = {name: {f"{layer}.{p}": blob[name][f"net.{i}.{p}"]
                             for i, layer in ((0, "fc_in"), (2, "fc_out"))
                             for p in ("weight", "bias")}
                      for name in MODALITY_DIMS if name in blob}
        self.load_params(params)
        logger.info("loaded projector weights from %s", path)

    def save_weights(self, path: str | Path) -> None:
        """``.npz`` (f32, kernels ``[in, out]``) or ``.pt`` (f16, the
        ``net.0`` / ``net.2`` layout)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        states = {name: {k: v.detach().cpu() for k, v in head.state_dict().items()}
                  for name, head in self.heads.items()}
        if path.suffix == ".npz":
            flat = {}
            for name, state in states.items():
                for layer in _LAYERS:
                    flat[f"{name}/{layer}/kernel"] = state[f"{layer}.weight"].numpy().T
                    flat[f"{name}/{layer}/bias"] = state[f"{layer}.bias"].numpy()
            np.savez(path, **flat)
        else:
            torch.save({name: {f"net.{i}.{p}": state[f"{layer}.{p}"].half()
                               for i, layer in ((0, "fc_in"), (2, "fc_out"))
                               for p in ("weight", "bias")}
                        for name, state in states.items()}, path)
        logger.info("saved projector weights to %s", path)


def create_projector_bank(config: Optional[ReasoningCoreConfig] = None,
                          weights_path: Optional[str] = None, seed: int = 0,
                          device: str | torch.device = "cuda") -> ProjectorBank:
    """A bank drawn from ``seed``, holding the trained weights at
    ``weights_path`` when that file exists."""
    bank = ProjectorBank(config, device).init(seed)
    if weights_path and Path(weights_path).exists():
        bank.load_weights(weights_path)
    return bank
