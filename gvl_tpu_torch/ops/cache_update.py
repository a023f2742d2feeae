"""In-place KV-cache append: Hopper kernels and their plain versions.

Counterpart of :mod:`gvl_tpu.ops.cache_update`.  :func:`cache_append`
launches ``csrc/cache_append.cu`` on CUDA tensors, which replaces the TPU
kernel ``gvl_tpu/ops/cache_update.py:cache_append``: it writes one row per
(slot, KV head) at ``positions[slot]`` into the cache where it lies and
returns the same tensor, as the TPU kernel's output aliases its input.
:func:`cache_append_stacked` (the same source, its own entry point)
replaces ``cache_append_stacked``: the same write into layer ``layer`` of a
cache stacked over layers, ``[L, B, Hkv, S_max, D]``.  On CPU tensors both
run their plain versions, which, like the JAX functions, return new tensors.
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
    row_bytes = _row_bytes("cache_append", cache)
    err = _build.library().gvl_cache_append(
        cache.data_ptr(), new.data_ptr(), positions.data_ptr(), batch,
        num_kv_heads, s_max, row_bytes, _build.stream_handle(cache.device))
    _build.check(err, "cache_append")
    cache_append.launches += 1
    return cache


cache_append.launches = 0


def _row_bytes(name: str, cache: torch.Tensor) -> int:
    row_bytes = cache.shape[-1] * cache.element_size()
    if row_bytes % 16:
        raise ValueError(f"{name}: rows of {row_bytes} bytes; the kernel"
                         " copies 16-byte words")
    return row_bytes


def cache_append_stacked_reference(cache: torch.Tensor, new: torch.Tensor,
                                   positions: torch.Tensor,
                                   layer: int) -> torch.Tensor:
    """``cache`` [L, B, Hkv, S_max, D] with :func:`cache_append_reference`
    applied to layer ``layer`` (a copy)."""
    out = cache.clone()
    out[layer] = cache_append_reference(cache[layer], new, positions)
    return out


def cache_append_stacked(cache: torch.Tensor, new: torch.Tensor,
                         positions: torch.Tensor, layer: int) -> torch.Tensor:
    """Write ``new`` [B, Hkv, D] at ``positions`` [B] of layer ``layer`` of
    ``cache`` [L, B, Hkv, S_max, D].

    On CUDA tensors the kernel adds the layer's offset itself, writes in
    place and returns the cache itself (same ``data_ptr()``); it takes what
    :func:`cache_append` takes and ``0 <= layer < L``.  Each launch adds one
    to ``cache_append_stacked.launches``.  On CPU tensors the plain version
    returns a new tensor.
    """
    if cache.device.type == "cpu":
        return cache_append_stacked_reference(cache, new, positions, layer)
    _build.require_cuda("cache_append_stacked", cache, new, positions)
    if cache.dim() != 5 or not 0 <= int(layer) < cache.shape[0]:
        raise ValueError(f"cache_append_stacked: layer {layer} of a cache "
                         f"{tuple(cache.shape)}")
    n_layers, batch, num_kv_heads, s_max, head_dim = cache.shape
    if new.dtype != cache.dtype or new.shape != (batch, num_kv_heads, head_dim):
        raise ValueError(f"cache_append_stacked: new must be {cache.dtype} "
                         f"{(batch, num_kv_heads, head_dim)}, got {new.dtype} "
                         f"{tuple(new.shape)}")
    if positions.dtype != torch.int32 or positions.shape != (batch,):
        raise ValueError(f"cache_append_stacked: positions must be int32 "
                         f"[{batch}], got {positions.dtype} "
                         f"{tuple(positions.shape)}")
    row_bytes = _row_bytes("cache_append_stacked", cache)
    err = _build.library().gvl_cache_append_stacked(
        cache.data_ptr(), new.data_ptr(), positions.data_ptr(), n_layers,
        int(layer), batch, num_kv_heads, s_max, row_bytes,
        _build.stream_handle(cache.device))
    _build.check(err, "cache_append_stacked")
    cache_append_stacked.launches += 1
    return cache


cache_append_stacked.launches = 0
