"""Layers shared by the port's models (counterpart of :mod:`gvl_tpu.nn.layers`)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
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


class LayerNorm(nn.Module):
    """LayerNorm over the last axis in f32, the result cast back to the
    input's type (Flax's ``LayerNorm`` as ``gvl_tpu.nn.layers`` uses
    it).  Parameters ``weight`` (scale) and ``bias``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def _dense(in_dim: int, out_dim: int, quant: bool, quant_static: bool,
           use_bias: bool = True) -> nn.Module:
    if quant:
        from gvl_tpu_torch.nn.quant import W8A8Dense

        return W8A8Dense(in_dim, out_dim, use_bias=use_bias, static_act=quant_static)
    return nn.Linear(in_dim, out_dim, bias=use_bias)


class Attention(nn.Module):
    """Multi-head self-attention of the encoder family (bias on every
    projection, no mask but an optional key length), input and output
    ``[B, S, D]``; heads go to :func:`gvl_tpu_torch.ops.attention.
    flash_attention` as ``[B, H, S, dh]`` (``gvl_tpu.nn.layers.Attention``
    with ``quant`` / ``quant_static``: W8A8 projections)."""

    def __init__(self, dim: int, num_heads: int, *, quant: bool = False,
                 quant_static: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        inner = num_heads * self.head_dim
        self.q_proj = _dense(dim, inner, quant, quant_static)
        self.k_proj = _dense(dim, inner, quant, quant_static)
        self.v_proj = _dense(dim, inner, quant, quant_static)
        self.o_proj = _dense(inner, dim, quant, quant_static)

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                kv_len: Optional[int] = None) -> torch.Tensor:
        from gvl_tpu_torch.ops.attention import flash_attention

        kv_in = x if kv is None else kv
        batch, seq_q, _ = x.shape

        def heads(t):
            return t.view(batch, -1, self.num_heads, self.head_dim).transpose(1, 2).contiguous()

        out = flash_attention(heads(self.q_proj(x)), heads(self.k_proj(kv_in)),
                              heads(self.v_proj(kv_in)), kv_len=kv_len)
        out = out.transpose(1, 2).reshape(batch, seq_q, self.num_heads * self.head_dim)
        return self.o_proj(out)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximated GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


class MlpGelu(nn.Module):
    """fc1 → tanh GELU → fc2 (``gvl_tpu.nn.layers.MlpGelu``)."""

    def __init__(self, dim: int, intermediate_dim: int, *, quant: bool = False,
                 quant_static: bool = False):
        super().__init__()
        self.fc1 = _dense(dim, intermediate_dim, quant, quant_static)
        self.fc2 = _dense(intermediate_dim, dim, quant, quant_static)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_tanh(self.fc1(x)))


class TransformerBlock(nn.Module):
    """Pre-norm LayerNorm/GELU encoder layer (``gvl_tpu.nn.layers.
    TransformerBlock`` with ``norm="layernorm"``, ``mlp="gelu"``):
    ``x + attention(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, dim: int, num_heads: int, intermediate_dim: int, *,
                 eps: float = 1e-6, quant: bool = False, quant_static: bool = False):
        super().__init__()
        self.ln1 = LayerNorm(dim, eps)
        self.attention = Attention(dim, num_heads, quant=quant, quant_static=quant_static)
        self.ln2 = LayerNorm(dim, eps)
        self.mlp = MlpGelu(dim, intermediate_dim, quant=quant, quant_static=quant_static)

    def forward(self, x: torch.Tensor, kv_len: Optional[int] = None) -> torch.Tensor:
        x = x + self.attention(self.ln1(x), kv_len=kv_len)
        return x + self.mlp(self.ln2(x))
