"""Rotary position embeddings (GPT-NeoX half rotation), as
:mod:`gvl_tpu.ops.rope`: f32 angles, the result cast back to x's type."""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                base: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` (any shape), each [..., head_dim]."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freqs = torch.pow(torch.tensor(base, dtype=torch.float32,
                                   device=positions.device), exponent)
    angles = positions[..., None].to(torch.float32) * freqs
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., S, D] by per-position cos/sin (broadcastable)."""
    return (x * cos + rotate_half(x) * sin).to(x.dtype)
