"""In-place KV-cache append: Hopper kernels and their plain versions.

Counterpart of :mod:`gvl_tpu.ops.cache_update`.  :func:`cache_append`
launches ``csrc/cache_append.cu`` on CUDA tensors, which replaces the TPU
kernel ``gvl_tpu/ops/cache_update.py:cache_append``: it writes one row per
(slot, KV head) at ``positions[slot]`` into the cache where it lies and
returns the same tensor, as the TPU kernel's output aliases its input.
:func:`cache_append_stacked` (the same source, its own entry point)
replaces ``cache_append_stacked``: the same write into layer ``layer`` of a
cache stacked over layers, ``[L, B, Hkv, S_max, D]``.

A decode step writes a few kilobytes, so a launch costs the host's dispatch
and nothing on the device to speak of.  :func:`cache_append_kv` and
:func:`cache_append_stacked_kv` therefore write a layer's K and V caches in
one launch of the same kernel, and every form takes f32 rows into a bf16
cache and converts them in the kernel, so the model launches no cast.  A
pair launch counts once, on ``cache_append.launches`` or
``cache_append_stacked.launches``: the TPU kernel it replaces.

On CPU tensors the single forms run their plain versions, which, like the
JAX functions, return new tensors.  The pair forms, which the model's
decode calls, make the same write in place there with the plain scatter
(:func:`write_rows`) and return the caches themselves, as on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from gvl_tpu_torch.ops import _build

_I32, _F32, _BF16 = torch.int32, torch.float32, torch.bfloat16


def cache_append_reference(cache: torch.Tensor, new: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """``cache`` with ``new[b]`` written at row ``positions[b]`` (a copy).

    cache: [B, Hkv, S_max, D]; new: [B, Hkv, D]; positions: [B].  A
    position outside ``[0, S_max)`` writes nothing, as in the kernel.
    """
    return write_rows(cache.clone(), new, positions)


def write_rows(cache: torch.Tensor, new: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """The plain write of :func:`cache_append_reference`, into ``cache``
    itself, which it returns."""
    pos = positions.to(cache.device).long()
    ok = (pos >= 0) & (pos < cache.shape[2])
    slot = torch.arange(cache.shape[0], device=cache.device)[ok]
    cache[slot, :, pos[ok], :] = new[ok].to(cache.dtype)
    return cache


def cache_append_stacked_reference(cache: torch.Tensor, new: torch.Tensor,
                                   positions: torch.Tensor,
                                   layer: int) -> torch.Tensor:
    """``cache`` [L, B, Hkv, S_max, D] with :func:`cache_append_reference`
    applied to layer ``layer`` (a copy)."""
    out = cache.clone()
    out[layer] = cache_append_reference(cache[layer], new, positions)
    return out


def cache_append_kv_reference(k_cache, v_cache, k_new, v_new, positions):
    """:func:`cache_append_reference` applied to each cache: (K, V) copies."""
    return (cache_append_reference(k_cache, k_new, positions),
            cache_append_reference(v_cache, v_new, positions))


def cache_append_stacked_kv_reference(k_cache, v_cache, k_new, v_new, positions,
                                      layer: int):
    """:func:`cache_append_stacked_reference` applied to each cache."""
    return (cache_append_stacked_reference(k_cache, k_new, positions, layer),
            cache_append_stacked_reference(v_cache, v_new, positions, layer))


def appends_in_kernel(cache: torch.Tensor, new: torch.Tensor) -> bool:
    """Whether the kernel takes rows of ``new``'s type into ``cache``: rows
    of a multiple of 16 bytes, of the cache's type or f32 into bf16."""
    return ((cache.shape[-1] * cache.element_size()) % 16 == 0
            and (new.dtype is cache.dtype
                 or (new.dtype is _F32 and cache.dtype is _BF16)))


def _launch(name: str, k_cache: torch.Tensor, v_cache: Optional[torch.Tensor],
            k_new: torch.Tensor, v_new: Optional[torch.Tensor],
            positions: torch.Tensor, layer: Optional[int]) -> None:
    """Check what the kernel takes and launch it once (one cache when
    ``v_cache`` is None; one layer's cache when ``layer`` is None).  The
    launch is all the host's work, so the checks read tensor attributes
    only: no ``torch.device``, no slice of a shape, dtypes by identity."""
    shape = k_cache.shape
    if len(shape) != (4 if layer is None else 5):
        want = "[B, Hkv, S_max, D]" if layer is None else "[L, B, Hkv, S_max, D]"
        raise ValueError(f"{name}: cache must be {want}, got {tuple(shape)}")
    if layer is None:
        batch, num_kv_heads, s_max, head_dim = shape
    else:
        n_layers, batch, num_kv_heads, s_max, head_dim = shape
        if not 0 <= layer < n_layers:
            raise ValueError(f"{name}: layer {layer} of a cache {tuple(shape)}")
    dtype, row_dtype = k_cache.dtype, k_new.dtype
    cast = row_dtype is not dtype
    if (k_new.shape != (batch, num_kv_heads, head_dim)
            or (cast and (row_dtype is not _F32 or dtype is not _BF16))):
        raise ValueError(f"{name}: new must be {dtype} (or f32 into a bf16 cache) "
                         f"{(batch, num_kv_heads, head_dim)}, got {row_dtype} "
                         f"{tuple(k_new.shape)}")
    if positions.dtype is not _I32 or positions.shape != (batch,):
        raise ValueError(f"{name}: positions must be int32 [{batch}], "
                         f"got {positions.dtype} {tuple(positions.shape)}")
    row_bytes = head_dim * k_cache.element_size()
    if row_bytes % 16:
        raise ValueError(f"{name}: rows of {row_bytes} bytes; the kernel"
                         " copies 16-byte words")
    if v_cache is None:
        index = _build.require_cuda(name, k_cache, k_new, positions)
        k_ptr, k_src, v_ptr, v_src = k_cache.data_ptr(), k_new.data_ptr(), None, None
        aligned = k_ptr | k_src
    else:
        if v_cache.shape != shape or v_cache.dtype is not dtype:
            raise ValueError(f"{name}: V cache {v_cache.dtype} {tuple(v_cache.shape)}"
                             f" is not K's {dtype} {tuple(shape)}")
        if v_new.shape != k_new.shape or v_new.dtype is not row_dtype:
            raise ValueError(f"{name}: V rows {v_new.dtype} {tuple(v_new.shape)}"
                             f" are not K's {row_dtype} {tuple(k_new.shape)}")
        index = _build.require_cuda(name, k_cache, v_cache, k_new, v_new, positions)
        k_ptr, k_src = k_cache.data_ptr(), k_new.data_ptr()
        v_ptr, v_src = v_cache.data_ptr(), v_new.data_ptr()
        nbytes = k_cache.nbytes
        if k_ptr < v_ptr + nbytes and v_ptr < k_ptr + nbytes:
            raise ValueError(f"{name}: the K and V caches share memory")
        aligned = k_ptr | k_src | v_ptr | v_src
    if aligned % 16:
        raise ValueError(f"{name}: caches and rows must be 16-byte aligned")
    if layer is None:
        err = _build.entry("gvl_cache_append")(
            k_ptr, v_ptr, k_src, v_src, positions.data_ptr(), batch, num_kv_heads,
            s_max, row_bytes, cast, _build.stream_handle(index))
    else:
        err = _build.entry("gvl_cache_append_stacked")(
            k_ptr, v_ptr, k_src, v_src, positions.data_ptr(), n_layers, layer, batch,
            num_kv_heads, s_max, row_bytes, cast, _build.stream_handle(index))
    if err:
        _build.check(err, name)


def cache_append(cache: torch.Tensor, new: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Write ``new`` [B, Hkv, D] at ``positions`` [B] of ``cache``
    [B, Hkv, S_max, D].

    On CUDA tensors the kernel writes in place and the cache itself is
    returned (same ``data_ptr()``); rows other than ``positions[b]`` are
    untouched and a position outside ``[0, S_max)`` writes nothing.  It
    takes ``new`` of the cache's type or f32 rows into a bf16 cache
    (converted as ``new.to(cache.dtype)`` does), int32 positions,
    contiguous 16-byte aligned tensors and rows of a multiple of 16 bytes;
    anything else raises.  Each launch adds one to
    ``cache_append.launches``.  On CPU tensors the plain version returns a
    new tensor.
    """
    if cache.is_cpu:
        return cache_append_reference(cache, new, positions)
    _launch("cache_append", cache, None, new, None, positions, None)
    _build.count_launch(cache_append)
    return cache


cache_append.launches = 0


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
    if cache.is_cpu:
        return cache_append_stacked_reference(cache, new, positions, layer)
    _launch("cache_append_stacked", cache, None, new, None, positions, int(layer))
    _build.count_launch(cache_append_stacked)
    return cache


cache_append_stacked.launches = 0


def cache_append_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`cache_append` into a layer's K and V caches in one launch.

    Takes what :func:`cache_append` takes, for two caches of one shape and
    type that share no memory and rows of one type, and returns ``(k_cache,
    v_cache)`` themselves.  Each launch adds one to
    ``cache_append.launches``.  On CPU tensors the plain scatter writes in
    place.
    """
    if k_cache is v_cache:
        raise ValueError("cache_append_kv: the K and V caches are one tensor")
    if k_cache.is_cpu:
        return write_rows(k_cache, k_new, positions), write_rows(v_cache, v_new, positions)
    _launch("cache_append_kv", k_cache, v_cache, k_new, v_new, positions, None)
    _build.count_launch(cache_append)
    return k_cache, v_cache


def cache_append_stacked_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
                            k_new: torch.Tensor, v_new: torch.Tensor,
                            positions: torch.Tensor,
                            layer: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`cache_append_stacked` into layer ``layer`` of the stacked K
    and V caches in one launch; takes what :func:`cache_append_kv` takes.
    Each launch adds one to ``cache_append_stacked.launches``; on CPU
    tensors the plain scatter writes in place."""
    if k_cache is v_cache:
        raise ValueError("cache_append_stacked_kv: the K and V caches are one tensor")
    if k_cache.is_cpu:
        write_rows(k_cache[layer], k_new, positions)
        write_rows(v_cache[layer], v_new, positions)
        return k_cache, v_cache
    _launch("cache_append_stacked_kv", k_cache, v_cache, k_new, v_new, positions,
            int(layer))
    _build.count_launch(cache_append_stacked)
    return k_cache, v_cache
