"""Layers shared by the port's models (counterpart of :mod:`gvl_tpu.nn.layers`)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class RMSNorm(nn.Module):
    """Root-mean-square norm over the last axis: f32 accumulation, the
    result cast back to the input's type (``gvl_tpu.nn.layers.RMSNorm``).

    With ``stack=(L,)`` the scale is ``[L, dim]``, one per layer of a model
    whose weights are stacked over layers, and ``index`` picks the layer.
    """

    def __init__(self, dim: int, eps: float = 1e-6, stack: tuple = ()):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(*stack, dim))

    def forward(self, x: torch.Tensor, index: Optional[int] = None) -> torch.Tensor:
        weight = self.weight if index is None else self.weight[index]
        xf = x.float()
        norm = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (norm * weight.float()).to(x.dtype)
