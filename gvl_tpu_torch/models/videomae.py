"""VideoMAE temporal encoder (counterpart of :mod:`gvl_tpu.models.videomae`).

16-frame clips → clip embeddings, the mean over tokens.  The 3-D tubelet
convolution is a reshape and one matrix product; positions are the fixed
sinusoidal table; the layers are pre-LN with BEiT-style attention biases
(q and v only) and exact GELU, their attention through the flash kernel
(:func:`gvl_tpu_torch.nn.layers.attend`).  Video is channels-last
``[B, T, H, W, 3]`` as in the JAX package.  ``convert_hf_videomae`` and
``load_hf_videomae`` read HF ``VideoMAEModel`` checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch.nn.layers import LayerNorm, attend


@dataclass(frozen=True)
class VideoMAEConfig:
    """Defaults: MCG-NJU/videomae-base."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 224
    patch_size: int = 16
    num_frames: int = 16
    tubelet_size: int = 2
    layer_norm_eps: float = 1e-12

    @property
    def tokens_per_clip(self) -> int:
        spatial = (self.image_size // self.patch_size) ** 2
        return spatial * (self.num_frames // self.tubelet_size)

    @classmethod
    def base(cls) -> "VideoMAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VideoMAEConfig":
        return cls(hidden_size=32, intermediate_size=64, num_layers=1,
                   num_heads=2, image_size=32, patch_size=16, num_frames=4,
                   tubelet_size=2)


def sinusoid_table(n_position: int, dim: int) -> np.ndarray:
    """HF VideoMAE fixed sinusoidal position table [n_position, dim]."""
    pos = np.arange(n_position)[:, None]
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, 2 * (i // 2) / dim)
    table = np.zeros((n_position, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class TubeletEmbed(nn.Module):
    """3-D tubelet patchify as one product: each (t, p, p) tubelet
    flattens in (C, t, ph, pw) order, torch's Conv3d im2col layout."""

    def __init__(self, config: VideoMAEConfig, channels: int = 3):
        super().__init__()
        self.config = config
        self.proj = nn.Linear(channels * config.tubelet_size * config.patch_size ** 2,
                              config.hidden_size)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, t, h, w, c = video.shape
        ts, p = cfg.tubelet_size, cfg.patch_size
        nt, nh, nw = t // ts, h // p, w // p
        x = video.reshape(b, nt, ts, nh, p, nw, p, c)
        x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, nt * nh * nw, c * ts * p * p)
        return self.proj(x)


class VideoMAELayer(nn.Module):
    """Pre-LN block with BEiT-style attention biases (q and v only)."""

    use_flash_kernel = True

    def __init__(self, config: VideoMAEConfig):
        super().__init__()
        d = config.hidden_size
        self.num_heads = config.num_heads
        self.norm_before = LayerNorm(d, config.layer_norm_eps)
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d)
        self.o_proj = nn.Linear(d, d)
        self.norm_after = LayerNorm(d, config.layer_norm_eps)
        self.fc1 = nn.Linear(d, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, seq, d = x.shape
        h = self.norm_before(x)

        def split(t):
            return t.view(batch, seq, self.num_heads, -1).transpose(1, 2).contiguous()

        attn = attend(self, split(self.q_proj(h)), split(self.k_proj(h)), split(self.v_proj(h)))
        x = x + self.o_proj(attn.transpose(1, 2).reshape(batch, seq, d))
        h = F.gelu(self.fc1(self.norm_after(x)))
        return x + self.fc2(h)


class VideoMAEEncoder(nn.Module):
    """Tubelet embed + sinusoidal positions + transformer stack."""

    def __init__(self, config: VideoMAEConfig):
        super().__init__()
        self.config = config
        self.patch_embed = TubeletEmbed(config)
        self.layers = nn.ModuleList(VideoMAELayer(config) for _ in range(config.num_layers))

    def forward(self, video: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.patch_embed(video)
        pos = torch.from_numpy(sinusoid_table(x.shape[1], self.config.hidden_size))
        x = x + pos[None].to(device=x.device, dtype=x.dtype)
        for layer in self.layers:
            x = layer(x)
        # the framework's clip embedding (the reference mean-pools)
        return {"last_hidden_state": x, "clip_embedding": x.mean(1)}


_LAYER_NAMES = {"norm_before": "layernorm_before", "q_proj": "attention.attention.query",
                "k_proj": "attention.attention.key", "v_proj": "attention.attention.value",
                "o_proj": "attention.output.dense", "norm_after": "layernorm_after",
                "fc1": "intermediate.dense", "fc2": "output.dense"}


def convert_hf_videomae(state_dict: dict, config: VideoMAEConfig) -> dict[str, torch.Tensor]:
    """A HF ``VideoMAEModel`` state dict as the port's :class:`VideoMAEEncoder`
    state dict (JAX's ``convert_hf_videomae``): the tubelet convolution's
    weight ``[D, C, t, kh, kw]`` flattens to the projection's ``[D,
    C*t*kh*kw]``; the q and v biases are BEiT-style parameters of their
    own, k has none."""
    sd = {k.removeprefix("videomae."): torch.as_tensor(v) for k, v in state_dict.items()}
    conv = sd["embeddings.patch_embeddings.projection.weight"]
    out = {"patch_embed.proj.weight": conv.reshape(conv.shape[0], -1),
           "patch_embed.proj.bias": sd["embeddings.patch_embeddings.projection.bias"]}
    for i in range(config.num_layers):
        pre = f"encoder.layer.{i}."
        for ours, theirs in _LAYER_NAMES.items():
            out[f"layers.{i}.{ours}.weight"] = sd[pre + theirs + ".weight"]
            if ours not in ("q_proj", "k_proj", "v_proj"):
                out[f"layers.{i}.{ours}.bias"] = sd[pre + theirs + ".bias"]
        out[f"layers.{i}.q_proj.bias"] = sd[pre + "attention.attention.q_bias"]
        out[f"layers.{i}.v_proj.bias"] = sd[pre + "attention.attention.v_bias"]
    return out


def hf_videomae_config(hf) -> VideoMAEConfig:
    """The port's config for a HF ``VideoMAEConfig``."""
    return VideoMAEConfig(
        hidden_size=hf.hidden_size, intermediate_size=hf.intermediate_size,
        num_layers=hf.num_hidden_layers, num_heads=hf.num_attention_heads,
        image_size=hf.image_size, patch_size=hf.patch_size, num_frames=hf.num_frames,
        tubelet_size=hf.tubelet_size)


def load_hf_videomae(model_name_or_path, config: Optional[VideoMAEConfig] = None
                     ) -> tuple[VideoMAEConfig, dict[str, torch.Tensor]]:
    """A HF ``VideoMAEModel`` checkpoint (a local directory) as ``(config,
    state_dict)`` on the CPU; ``transformers`` is imported here only."""
    from transformers import VideoMAEModel

    model = VideoMAEModel.from_pretrained(model_name_or_path)
    config = config or hf_videomae_config(model.config)
    return config, convert_hf_videomae(model.state_dict(), config)


def load_videomae(config: VideoMAEConfig, state: dict[str, torch.Tensor],
                  device: str | torch.device = "cuda") -> VideoMAEEncoder:
    """The port's state dict as a :class:`VideoMAEEncoder` on ``device``."""
    from gvl_tpu_torch import resolve_device
    from gvl_tpu_torch.nn.layers import load_module

    device = resolve_device(device)
    with torch.device("meta"):
        model = VideoMAEEncoder(config)
    return load_module(model, state, device)
