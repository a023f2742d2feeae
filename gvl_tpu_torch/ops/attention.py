"""Flash-attention forward: a Hopper kernel and its plain PyTorch version.

Counterpart of :mod:`gvl_tpu.ops.attention`.  :func:`flash_attention`
launches ``csrc/flash_attention.cu`` (bf16 tensor cores; f32 operands split
into bf16 hi + lo) on CUDA tensors, which replaces the TPU kernel
``gvl_tpu/ops/attention.py:flash_attention``, and runs
:func:`attention_reference` on CPU tensors.  Both take the JAX package's
``[B, H, S, D]`` layout, grouped-query heads (KV head ``h // group``), a
causal mask and a key-padding mask (keys at or past ``kv_len``).  Masked
scores are ``-1e30``, not ``-inf``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from gvl_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 128, 192)   # head sizes the kernel is built for


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain attention with the kernel's masking (the CPU path and the
    ground truth the kernel is held to).

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] with Hq a multiple of Hkv.
    Scores are f32; the softmax weights are cast to v's type for P @ V, as
    in ``gvl_tpu.ops.attention.attention_reference``.  Returns q's type.
    """
    _, num_q_heads, seq_q, head_dim = q.shape
    num_kv_heads, seq_k = k.shape[1], k.shape[2]
    group = num_q_heads // num_kv_heads
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_len is not None and kv_len < seq_k:
        col = torch.arange(seq_k, device=q.device)
        s = s.masked_fill(col >= kv_len, NEG_INF)
    if causal:
        row = torch.arange(seq_q, device=q.device)[:, None]
        col = torch.arange(seq_k, device=q.device)[None, :]
        s = s.masked_fill(col > row, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def _pad_head(t: torch.Tensor, padded: int) -> torch.Tensor:
    """``t`` zero-padded on its last axis to ``padded``; copied in 8-byte
    units where its rows allow (4 bf16 at a time: PyTorch's pad copies
    element by element into the strided rows, so this moves 4x fewer
    elements for the same bytes)."""
    unit = 8 // t.element_size()
    pad = padded - t.shape[-1]
    if t.shape[-1] % unit == 0 and pad % unit == 0 and t.storage_offset() % unit == 0:
        return F.pad(t.view(torch.int64), (0, pad // unit)).view(t.dtype)
    return F.pad(t, (0, pad))


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Raise unless the kernel takes q, k, v, zero-padded on the head axis
    to the head size it returns (q's head_dim, or the next of
    :data:`HEAD_DIMS` above it)."""
    batch, num_q_heads, _, head_dim = q.shape
    num_kv_heads = k.shape[1]
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share f32 or bf16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    padded = next((d for d in HEAD_DIMS if d >= head_dim), head_dim)
    if padded not in HEAD_DIMS or k.shape[-1] != head_dim or v.shape != k.shape:
        raise ValueError(f"flash_attention: head_dim must be at most {HEAD_DIMS[-1]}"
                         f" and k, v alike; got {q.shape}, {k.shape}, {v.shape}")
    if k.shape[0] != batch or num_q_heads % num_kv_heads or min(q.shape) == 0:
        raise ValueError(f"flash_attention: shapes {q.shape}, {k.shape}")
    return padded


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention forward: the Hopper kernel on CUDA tensors, the plain
    version on CPU tensors.  Arguments as :func:`attention_reference`.

    The kernel takes f32 or bf16 (one type for q, k and v), head_dim 64,
    80, 128 or 192 and contiguous tensors; anything else raises.  Another
    head_dim up to 192 (72 in SigLIP so400m, 176 in HiCo) is zero-padded to
    the next of those and the output sliced back, as the JAX package pads
    heads to a multiple of 128 lanes; the softmax scale stays at the true
    head_dim.  Each launch adds
    one to ``flash_attention.launches``.
    """
    if q.is_cpu:
        return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                                   kv_len=kv_len)
    index = _build.require_cuda("flash_attention", q, k, v)
    batch, num_q_heads, seq_q, head_dim = q.shape
    _, num_kv_heads, seq_k, _ = k.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
    padded = _check_flash(q, k, v)
    if padded != head_dim:
        out = flash_attention(_pad_head(q, padded), _pad_head(k, padded),
                              _pad_head(v, padded), causal=causal, sm_scale=scale,
                              kv_len=kv_len)
        return out[..., :head_dim]
    valid = seq_k if kv_len is None else max(0, min(int(kv_len), seq_k))
    out = torch.empty_like(q)
    err = _build.entry("gvl_flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), batch,
        num_q_heads, num_kv_heads, seq_q, seq_k, head_dim, valid, int(causal),
        scale, _build.DTYPE_CODES[q.dtype], _build.stream_handle(index))
    _build.check(err, "flash_attention")
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
