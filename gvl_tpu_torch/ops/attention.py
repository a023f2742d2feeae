"""Flash-attention forward: a Hopper kernel and its plain PyTorch version.

Counterpart of :mod:`gvl_tpu.ops.attention`.  :func:`flash_attention`
launches ``csrc/flash_attention.cu`` (bf16 tensor cores; f32 operands split
into bf16 hi + lo) on CUDA tensors, which replaces the TPU kernel
``gvl_tpu/ops/attention.py:flash_attention``, and runs
:func:`attention_reference` on CPU tensors.  Both take the JAX package's
``[B, H, S, D]`` layout, grouped-query heads (KV head ``h // group``), a
causal mask and a key-padding mask (keys at or past ``kv_len``).  Masked
scores are ``-1e30``, not ``-inf``.

:func:`dot_product_attention` is the differentiable entry point, the
counterpart of ``gvl_tpu.ops.attention.dot_product_attention``: a
``torch.autograd.Function`` whose forward is the kernel (or, with
``kernel=False``, the plain version) and whose backward is the JAX
package's plain backward, dense up to ``1024 * 1024`` scores per head and
blockwise over 512-query blocks past that, with ``delta`` from a forward
recompute through the same forward.  Without autograd (``inference_mode``,
``no_grad`` or inputs that need no gradient) it calls the forward alone.
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


# dense backward up to this many scores per (batch, head); past it the
# [Sq, Sk] f32 buffers of the dense form outgrow the device at training
# batch sizes and the blockwise backward takes over (the JAX package's
# ``_BWD_DENSE_MAX_SCORES`` and ``_BWD_BLOCK_Q``)
BWD_DENSE_MAX_SCORES = 1024 * 1024
BWD_BLOCK_Q = 512


def _forward(q, k, v, causal, sm_scale, kv_len, kernel):
    attend = flash_attention if kernel else attention_reference
    return attend(q, k, v, causal=causal, sm_scale=sm_scale, kv_len=kv_len)


def _scores(q, k, scale, causal, kv_len, row0: int = 0):
    """f32 masked scores of q rows ``row0 ...`` against every key."""
    seq_q, seq_k = q.shape[2], k.shape[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if kv_len is not None and kv_len < seq_k:
        col = torch.arange(seq_k, device=q.device)
        s = s.masked_fill(col >= kv_len, NEG_INF)
    if causal:
        row = torch.arange(row0, row0 + seq_q, device=q.device)[:, None]
        col = torch.arange(seq_k, device=q.device)[None, :]
        s = s.masked_fill(col > row, NEG_INF)
    return s


def _bwd_dense(q, k, v, g, causal, scale, kv_len):
    """Full-matrix backward in f32 (``_bwd_dense``): k, v have q's heads."""
    p = torch.softmax(_scores(q, k, scale, causal, kv_len), dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv


def _bwd_blockwise(q, k, v, g, out, causal, scale, kv_len, block_q):
    """Flash-style backward (``_bwd_blockwise``): one q-block at a time, so
    that no ``[Sq, Sk]`` matrix is ever held; ``out`` is the forward output
    recomputed for ``delta = rowsum(g * out)``.  The JAX package pads the
    last block with zero rows, which add nothing; here it is shorter."""
    delta = (g * out.float()).sum(-1)
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for start in range(0, q.shape[2], block_q):
        rows = slice(start, start + block_q)
        q_blk, g_blk = q[:, :, rows], g[:, :, rows]
        p = torch.softmax(_scores(q_blk, k, scale, causal, kv_len, start), dim=-1)
        ds = torch.matmul(g_blk, v.transpose(-1, -2))
        ds.sub_(delta[:, :, rows, None]).mul_(p)
        dq[:, :, rows] = torch.matmul(ds, k) * scale
        dk.add_(torch.matmul(ds.transpose(-1, -2), q_blk) * scale)
        dv.add_(torch.matmul(p.transpose(-1, -2), g_blk))
        del p, ds
    return dq, dk, dv


def attention_backward(q, k, v, g, causal: bool = False, sm_scale=None, kv_len=None,
                       kernel: bool = True):
    """(dq, dk, dv) of :func:`attention_reference` at q, k, v for the output
    gradient ``g``, in the inputs' types (``_attention_bwd``): products in
    f32 on q's heads (K and V repeated over each group, their gradients
    summed back over it); dense while ``Sq * Sk <= BWD_DENSE_MAX_SCORES``,
    else blockwise, whose ``delta`` recomputes the forward (the kernel
    unless ``kernel`` is off)."""
    batch, num_q_heads, seq_q, head_dim = q.shape
    num_kv_heads, seq_k = k.shape[1], k.shape[2]
    group = num_q_heads // num_kv_heads
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
    kf, vf = k.float(), v.float()
    if group > 1:
        kf, vf = kf.repeat_interleave(group, dim=1), vf.repeat_interleave(group, dim=1)
    qf, gf = q.float(), g.float()
    if seq_q * seq_k <= BWD_DENSE_MAX_SCORES:
        dq, dk, dv = _bwd_dense(qf, kf, vf, gf, causal, scale, kv_len)
    else:
        out = _forward(q, k, v, causal, scale, kv_len, kernel)
        dq, dk, dv = _bwd_blockwise(qf, kf, vf, gf, out, causal, scale, kv_len,
                                    min(BWD_BLOCK_Q, seq_q))
    if group > 1:
        dk = dk.view(batch, num_kv_heads, group, seq_k, head_dim).sum(2)
        dv = dv.view(batch, num_kv_heads, group, seq_k, head_dim).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    """Forward through the kernel (or the plain version), backward through
    :func:`attention_backward`; saves q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, kv_len, kernel):
        ctx.save_for_backward(q, k, v)
        ctx.options = (causal, sm_scale, kv_len, kernel)
        return _forward(q, k, v, causal, sm_scale, kv_len, kernel)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, g, *ctx.options)
        return dq, dk, dv, None, None, None, None


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kv_len: Optional[int] = None,
    kernel: bool = True,
) -> torch.Tensor:
    """Differentiable attention (arguments as :func:`attention_reference`).

    The forward is :func:`flash_attention` (the kernel on CUDA tensors, the
    plain version on CPU tensors) or, with ``kernel=False``, the plain
    version on any device; the backward is :func:`attention_backward`.
    Where autograd records nothing this is the forward alone, so serving
    launches what it launched before.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, sm_scale, kv_len, kernel)
    return _forward(q, k, v, causal, sm_scale, kv_len, kernel)
