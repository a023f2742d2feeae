"""VideoMAE temporal encoder (counterpart of :mod:`gvl_tpu.models.videomae`).

16-frame clips → clip embeddings, the mean over tokens.  The 3-D tubelet
convolution is a reshape and one matrix product; positions are the fixed
sinusoidal table; the layers are pre-LN with BEiT-style attention biases
(q and v only) and exact GELU, their attention through the flash kernel
(:func:`gvl_tpu_torch.nn.layers.attend`).  Video is channels-last
``[B, T, H, W, 3]`` as in the JAX package.  The HF converter and loader
(``convert_hf_videomae``, ``load_hf_videomae``) are not ported (ROADMAP
A10).
"""

from __future__ import annotations

from dataclasses import dataclass

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


def convert_hf_videomae(state_dict, config: VideoMAEConfig):
    """HF ``VideoMAEModel`` state dicts: not ported (ROADMAP A10)."""
    raise NotImplementedError("the HF VideoMAE converter is not ported yet (ROADMAP A10)")


def load_hf_videomae(model_name_or_path: str, config=None):
    """HF VideoMAE checkpoints: not ported (ROADMAP A10)."""
    raise NotImplementedError("HF VideoMAE checkpoints are not ported yet (ROADMAP A10)")
