"""Single-token decode attention over the live prefix of a KV cache.

Counterpart of :mod:`gvl_tpu.ops.decode_attention`.  :func:`decode_attention`
launches ``csrc/decode_attention.cu`` on CUDA tensors, which replaces the
TPU kernel ``gvl_tpu/ops/decode_attention.py:decode_attention``, and runs
:func:`decode_attention_reference` on CPU tensors.

Layout: q ``[B, Hq, D]`` (one token per slot), caches ``[B, Hkv, S_max, D]``,
lengths ``[B]`` (keys ``0 .. lengths[b] - 1`` are attended).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gvl_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_GROUP = 8   # query heads per KV head the kernel takes


def decode_attention_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked full-cache attention (the CPU path and the ground truth).

    As ``gvl_tpu.ops.decode_attention.decode_attention_reference``: f32
    scores (an f32 query against a bf16 cache promotes), softmax weights
    cast to the cache type, P @ V in the cache type, the result cast to
    q's type.
    """
    batch, num_q_heads, head_dim = q.shape
    _, num_kv_heads, s_max, _ = k_cache.shape
    group = num_q_heads // num_kv_heads
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
    qg = q.reshape(batch, num_kv_heads, group, head_dim).float()
    scores = torch.matmul(qg, k_cache.float().transpose(-1, -2)) * scale
    live = (torch.arange(s_max, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])                 # [B, S_max]
    scores = scores.masked_fill(~live[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.matmul(probs, v_cache)                       # [B, Hkv, G, D]
    return out.reshape(batch, num_q_heads, head_dim).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention: the Hopper kernel on CUDA tensors, the plain
    version on CPU tensors.  Returns ``[B, Hq, D]`` in q's type.

    The kernel takes an f32 or bf16 query against a bf16 cache, head_dim
    64 or 128, at most 8 query heads per KV head, int32 lengths and
    contiguous tensors; anything else raises.  Each call adds one to
    ``decode_attention.launches``.
    """
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          sm_scale=sm_scale)
    _build.require_cuda("decode_attention", q, k_cache, v_cache, lengths)
    batch, num_q_heads, head_dim = q.shape
    _, num_kv_heads, s_max, _ = k_cache.shape
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"decode_attention: q must be f32 or bf16, got {q.dtype}")
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise ValueError("decode_attention: the cache must be bf16, got "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (batch,):
        raise ValueError(f"decode_attention: lengths must be int32 [{batch}],"
                         f" got {lengths.dtype} {tuple(lengths.shape)}")
    if (head_dim not in HEAD_DIMS or k_cache.shape[0] != batch
            or k_cache.shape[-1] != head_dim or v_cache.shape != k_cache.shape
            or num_q_heads % num_kv_heads
            or num_q_heads // num_kv_heads > MAX_GROUP):
        raise ValueError(f"decode_attention: unsupported shapes {q.shape}, "
                         f"{k_cache.shape}, {v_cache.shape}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
    lib = _build.library()
    n_chunks = -(-s_max // lib.gvl_decode_attention_chunk())
    out = torch.empty_like(q)
    part_acc = torch.empty(batch, num_q_heads, n_chunks, head_dim,
                           dtype=torch.float32, device=q.device)
    part_ml = torch.empty(batch, num_q_heads, n_chunks, 2,
                          dtype=torch.float32, device=q.device)
    err = lib.gvl_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), batch, num_q_heads, num_kv_heads, s_max, head_dim,
        scale, _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
