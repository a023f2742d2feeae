"""In-place KV-cache append: a Hopper kernel and its plain version.

Counterpart of :mod:`gvl_tpu.ops.cache_update`.  :func:`cache_append`
launches ``csrc/cache_append.cu`` on CUDA tensors, which replaces the TPU
kernel ``gvl_tpu/ops/cache_update.py:cache_append``: it writes one row per
(slot, KV head) at ``positions[slot]`` into the cache where it lies and
returns the same tensor, as the TPU kernel's output aliases its input.
On CPU tensors it runs :func:`cache_append_reference`, which, like the JAX
function, returns a new tensor.
"""

from __future__ import annotations

import torch

from gvl_tpu_torch.ops import _build


def cache_append_reference(cache: torch.Tensor, new: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """``cache`` with ``new[b]`` written at row ``positions[b]`` (a copy).

    cache: [B, Hkv, S_max, D]; new: [B, Hkv, D]; positions: [B].  A
    position outside ``[0, S_max)`` writes nothing, as in the kernel.
    """
    out = cache.clone()
    pos = positions.to(cache.device).long()
    ok = (pos >= 0) & (pos < cache.shape[2])
    slot = torch.arange(cache.shape[0], device=cache.device)[ok]
    out[slot, :, pos[ok], :] = new[ok].to(cache.dtype)
    return out


def cache_append(cache: torch.Tensor, new: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Write ``new`` [B, Hkv, D] at ``positions`` [B] of ``cache``
    [B, Hkv, S_max, D].

    On CUDA tensors the kernel writes in place and the cache itself is
    returned (same ``data_ptr()``); rows other than ``positions[b]`` are
    untouched and a position outside ``[0, S_max)`` writes nothing.  It
    takes ``new`` of the cache's type, int32 positions, contiguous
    tensors and rows of a multiple of 16 bytes; anything else raises.
    Each launch adds one to ``cache_append.launches``.  On CPU tensors the
    plain version returns a new tensor.
    """
    if cache.device.type == "cpu":
        return cache_append_reference(cache, new, positions)
    _build.require_cuda("cache_append", cache, new, positions)
    batch, num_kv_heads, s_max, head_dim = cache.shape
    if new.dtype != cache.dtype or new.shape != (batch, num_kv_heads, head_dim):
        raise ValueError(f"cache_append: new must be {cache.dtype} "
                         f"{(batch, num_kv_heads, head_dim)}, got {new.dtype} "
                         f"{tuple(new.shape)}")
    if positions.dtype != torch.int32 or positions.shape != (batch,):
        raise ValueError(f"cache_append: positions must be int32 [{batch}], "
                         f"got {positions.dtype} {tuple(positions.shape)}")
    row_bytes = head_dim * cache.element_size()
    if row_bytes % 16:
        raise ValueError(f"cache_append: rows of {row_bytes} bytes; the kernel"
                         " copies 16-byte words")
    err = _build.library().gvl_cache_append(
        cache.data_ptr(), new.data_ptr(), positions.data_ptr(), batch,
        num_kv_heads, s_max, row_bytes, _build.stream_handle(cache.device))
    _build.check(err, "cache_append")
    cache_append.launches += 1
    return cache


cache_append.launches = 0
