"""Attention of one token or a chunk of tokens over the live prefix of a KV
cache: Hopper kernels and their plain PyTorch versions.

Counterpart of :mod:`gvl_tpu.ops.decode_attention`.  Each wrapper launches
its kernel on CUDA tensors and runs its plain version on CPU tensors:

- :func:`decode_attention` (``csrc/decode_attention.cu``) replaces the TPU
  kernel ``gvl_tpu/ops/decode_attention.py:decode_attention``: q
  ``[B, Hq, D]`` (one token per slot) over caches ``[B, Hkv, S_max, D]``,
  lengths ``[B]`` (keys ``0 .. lengths[b] - 1`` are attended).  One launch
  per call: a thread-block cluster per (slot, KV head) splits the live
  prefix and merges in shared memory, so the wrapper allocates only the
  output;
- :func:`decode_attention_stacked` (the same source, its own entry point)
  replaces ``decode_attention_stacked``: the same over layer ``layer`` of
  caches stacked over layers, ``[L, B, Hkv, S_max, D]``;
- :func:`chunk_attention` (``csrc/chunk_attention.cu``) replaces
  ``chunk_attention``: q ``[B, Hq, S, D]`` of a chunk written into the cache
  at per-slot offsets ``start`` ``[B]``; chunk row ``s`` attends keys
  ``0 .. start[b] + s``.  The TPU kernel refuses more than 512 query rows
  (S times the query heads per KV head) and its callers send larger chunks
  to the reference; the Hopper kernel tiles the rows and takes any chunk,
  so the port's model sends every chunk on the card through it (a fresh QA
  admission is a 2048- or 4096-token chunk).
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


def _check_decode(name: str, q, k_cache, v_cache, lengths, sm_scale,
                  dims: int = 4) -> tuple:
    """Raise unless the decode kernel takes these operands: caches of one
    layer, ``[B, Hkv, S_max, D]``, or with ``dims`` 5 stacked over layers,
    ``[L, B, Hkv, S_max, D]``.  Returns the kernel's arguments after the
    pointers (and the layers): ``(B, Hq, Hkv, S_max, D, scale, q_dtype)``."""
    batch, num_q_heads, head_dim = q.shape
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: q must be f32 or bf16, got {q.dtype}")
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the cache must be bf16, got "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (batch,):
        raise ValueError(f"{name}: lengths must be int32 [{batch}],"
                         f" got {lengths.dtype} {tuple(lengths.shape)}")
    shape = k_cache.shape
    if (len(shape) != dims or v_cache.shape != shape or shape[-4] != batch
            or shape[-1] != head_dim or head_dim not in HEAD_DIMS
            or num_q_heads % shape[-3] or num_q_heads // shape[-3] > MAX_GROUP):
        raise ValueError(f"{name}: unsupported shapes {q.shape}, "
                         f"{k_cache.shape}, {v_cache.shape}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
    return (batch, num_q_heads, shape[-3], shape[-2], head_dim, scale,
            _build.DTYPE_CODES[q.dtype])


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
    contiguous tensors; anything else raises.  A slot of length 0 gives 0
    on the card (the plain version, as JAX's reference, the mean of the
    values).  Each call adds one to ``decode_attention.launches``.
    """
    if q.is_cpu:
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          sm_scale=sm_scale)
    index = _build.require_cuda("decode_attention", q, k_cache, v_cache, lengths)
    args = _check_decode("decode_attention", q, k_cache, v_cache, lengths,
                         sm_scale)
    out = torch.empty_like(q)
    err = _build.entry("gvl_decode_attention")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), *args, _build.stream_handle(index))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_stacked_reference(
    q: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    lengths: torch.Tensor,
    layer: int,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`decode_attention_reference` on layer ``layer`` of caches
    stacked over layers, ``[L, B, Hkv, S_max, D]`` (a view, not a copy)."""
    return decode_attention_reference(q, k_all[layer], v_all[layer], lengths,
                                      sm_scale=sm_scale)


def decode_attention_stacked(
    q: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    lengths: torch.Tensor,
    layer: int,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`decode_attention` reading layer ``layer`` of the stacked caches
    ``[L, B, Hkv, S_max, D]``: the kernel adds the layer's offset itself, so
    nothing is sliced or copied.  Takes what :func:`decode_attention` takes
    and ``0 <= layer < L``; anything else raises.  Each call adds one to
    ``decode_attention_stacked.launches``.  CPU tensors take the plain
    version.
    """
    if q.is_cpu:
        return decode_attention_stacked_reference(q, k_all, v_all, lengths,
                                                  layer, sm_scale=sm_scale)
    index = _build.require_cuda("decode_attention_stacked", q, k_all, v_all, lengths)
    layer = int(layer)
    if k_all.dim() != 5 or not 0 <= layer < k_all.shape[0]:
        raise ValueError(f"decode_attention_stacked: layer {layer} of caches "
                         f"{tuple(k_all.shape)}")
    args = _check_decode("decode_attention_stacked", q, k_all, v_all, lengths,
                         sm_scale, dims=5)
    out = torch.empty_like(q)
    err = _build.entry("gvl_decode_attention_stacked")(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), k_all.shape[0], layer, *args, _build.stream_handle(index))
    _build.check(err, "decode_attention_stacked")
    decode_attention_stacked.launches += 1
    return out


decode_attention_stacked.launches = 0


def chunk_attention_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    start: torch.Tensor,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked full-cache attention of a chunk (the CPU path and the ground
    truth), as ``gvl_tpu.ops.decode_attention.chunk_attention_reference``.

    q: [B, Hq, S, D]; caches [B, Hkv, S_max, D] holding the chunk at rows
    ``start[b] ..``; start: [B].  Row ``s`` attends keys ``j < start[b] + s
    + 1``.  f32 scores, softmax weights cast to the cache type, P @ V in the
    cache type, the result cast to q's type.
    """
    batch, num_q_heads, seq, head_dim = q.shape
    _, num_kv_heads, s_max, _ = k_cache.shape
    group = num_q_heads // num_kv_heads
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
    qg = q.reshape(batch, num_kv_heads, group, seq, head_dim).float()
    scores = torch.matmul(qg, k_cache.float()[:, :, None].transpose(-1, -2))
    scores = scores * scale                                  # [B, Hkv, G, S, K]
    row_end = (start.to(q.device).long()[:, None]
               + torch.arange(seq, device=q.device)[None, :] + 1)   # [B, S]
    live = (torch.arange(s_max, device=q.device)[None, None, :]
            < row_end[:, :, None])                           # [B, S, K]
    scores = scores.masked_fill(~live[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.matmul(probs, v_cache[:, :, None])           # [B, Hkv, G, S, D]
    return out.reshape(batch, num_q_heads, seq, head_dim).to(q.dtype)


def chunk_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    start: torch.Tensor,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunk attention: the Hopper kernel on CUDA tensors, the plain version
    on CPU tensors.  Returns ``[B, Hq, S, D]`` in q's type.

    The kernel takes an f32 or bf16 query against a bf16 cache, head_dim 64
    or 128, any whole number of query heads per KV head and any chunk
    length, int32 starts and contiguous tensors; anything else raises.  The
    caller keeps ``start[b] + S <= S_max`` (keys past the cache are not
    read).  Each call adds one to ``chunk_attention.launches``.
    """
    if q.device.type == "cpu":
        return chunk_attention_reference(q, k_cache, v_cache, start,
                                         sm_scale=sm_scale)
    index = _build.require_cuda("chunk_attention", q, k_cache, v_cache, start)
    batch, num_q_heads, seq, head_dim = q.shape
    _, num_kv_heads, s_max, _ = k_cache.shape
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"chunk_attention: q must be f32 or bf16, got {q.dtype}")
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise ValueError("chunk_attention: the cache must be bf16, got "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if start.dtype != torch.int32 or start.shape != (batch,):
        raise ValueError(f"chunk_attention: start must be int32 [{batch}], "
                         f"got {start.dtype} {tuple(start.shape)}")
    if (head_dim not in HEAD_DIMS or k_cache.shape[0] != batch
            or k_cache.shape[-1] != head_dim or v_cache.shape != k_cache.shape
            or num_q_heads % num_kv_heads or seq == 0
            or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16):
        raise ValueError(f"chunk_attention: unsupported shapes {q.shape}, "
                         f"{k_cache.shape}, {v_cache.shape}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
    out = torch.empty_like(q)
    err = _build.entry("gvl_chunk_attention")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), start.data_ptr(),
        out.data_ptr(), batch, num_q_heads, num_kv_heads, seq, s_max, head_dim,
        scale, _build.DTYPE_CODES[q.dtype], _build.stream_handle(index))
    _build.check(err, "chunk_attention")
    chunk_attention.launches += 1
    return out


chunk_attention.launches = 0
