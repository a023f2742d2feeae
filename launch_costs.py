#!/usr/bin/env python3
"""The host's cost per call of every kernel wrapper of ``gvl_tpu_torch``.

    python3 launch_costs.py

Run from the root of the repository, on a machine with one CUDA card and
``nvcc``.  For each of the twelve kernel wrappers at its shape in
``chip_smoke.py`` phase 2, for the append kernel's pair forms, for the
library call each row is held against there (``chip_smoke.py``'s
``library_*`` yardsticks: the port calls none of them) and for the pieces
of a launch down to its floors (a ctypes call into the kernel library with
no argument, the launch of an empty kernel, the stream handle and the
device check, each as the port makes it now and as it made it before the
lean launch path): host microseconds per call from ``time.perf_counter``
over up to 3000 back-to-back calls and one synchronize, then CUDA events
over as many calls.  The empty kernel is built here, into
``gvl_tpu_torch/_build/launch_floor/``; it is no part of the port.  Prints
the card's name and power limit, one line per call, and one JSON object as
its last line.
"""

from __future__ import annotations

import ctypes
import json
import time

import torch

import chip_smoke as yard
from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.ops import _build

EMPTY_KERNEL = r"""
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def empty_launch_entry():
    """``empty_launch(stream)``: one block of one thread that does nothing,
    compiled with the port's nvcc flags into a library of its own."""
    out = _build.BUILD_DIR / "launch_floor"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "empty.cu", out / "libempty.so"
    src.write_text(EMPTY_KERNEL)
    _build._nvcc((_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                  str(src)), [lib])
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    return fn


def host_and_event_us(fn, budget_s: float = 0.2, max_calls: int = 3000) -> dict:
    """Microseconds per call of ``fn``: on the host clock over n
    back-to-back calls closed by one synchronize, then with CUDA events
    around another n; n fills about ``budget_s``, within 20 .. max_calls."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = int(min(max_calls, max(20, budget_s / max(time.perf_counter() - start, 1e-7))))
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - start) / n
    first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    first.record()
    for _ in range(n):
        fn()
    last.record()
    torch.cuda.synchronize()
    return {"host_us": 1e6 * host, "events_us": 1e3 * first.elapsed_time(last) / n,
            "calls": n}


def _require_cuda_before(name: str, *tensors: torch.Tensor) -> None:
    """The device check as the wrappers made it before the lean launch
    path (a torch.device per operand), kept to measure what it cost."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def launch_costs(dev) -> dict:
    """Host and event microseconds per call of every kernel wrapper at its
    phase-2 shape, of the library calls held against them, and of the
    pieces of a launch."""
    from gvl_tpu_torch.ops import quant_matmul as qm
    from gvl_tpu_torch.ops.attention import flash_attention
    from gvl_tpu_torch.ops.cache_update import (
        cache_append,
        cache_append_kv,
        cache_append_stacked,
        cache_append_stacked_kv,
    )
    from gvl_tpu_torch.ops.decode_attention import (
        chunk_attention,
        decode_attention,
        decode_attention_stacked,
    )

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    bf16 = torch.bfloat16
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _build.library()
    empty_launch = empty_launch_entry()
    stream = _build.stream_handle(index)
    # rows 1-6: the served decoders' shapes
    q, k, v = randn(1, 10, 4096, 64), randn(1, 5, 4096, 64), randn(1, 5, 4096, 64)
    qd = randn(1, 10, 64)
    kc, vc = randn(1, 5, 4608, 64, dtype=bf16), randn(1, 5, 4608, 64, dtype=bf16)
    live = torch.tensor([3072], dtype=torch.int32, device=dev)
    cache, cache_v = randn(1, 8, 1024, 128, dtype=bf16), randn(1, 8, 1024, 128, dtype=bf16)
    row, row_v = randn(1, 8, 128, dtype=bf16), randn(1, 8, 128, dtype=bf16)
    pos = torch.tensor([517], dtype=torch.int32, device=dev)
    pos_long, row3, row3_v = pos.long(), row[:, :, None], row_v[:, :, None]
    qc, start = randn(1, 10, 2048, 64), torch.zeros(1, dtype=torch.int32, device=dev)
    chunk_mask = torch.arange(2048, device=dev)[None, :] <= torch.arange(2048, device=dev)[:, None]
    k_all, v_all = (randn(4, 4, 8, 1024, 128, dtype=bf16) for _ in range(2))
    q4, lens4 = randn(4, 32, 128, dtype=bf16), torch.tensor([129, 134, 140, 144],
                                                            dtype=torch.int32, device=dev)
    rows4, rows4_v = randn(4, 8, 128, dtype=bf16), randn(4, 8, 128, dtype=bf16)
    pos4 = lens4 - 1
    st_mask = (torch.arange(1024, device=dev)[None, :] < lens4[:, None])[:, None, None, :]
    flat = ((torch.arange(4, device=dev)[:, None] * 8 + torch.arange(8, device=dev)[None, :])
            * 1024 + pos4[:, None].long()).reshape(-1)
    k_rows2, v_rows2 = k_all[2].view(-1, 128), v_all[2].view(-1, 128)
    new_k4, new_v4 = rows4.reshape(-1, 128), rows4_v.reshape(-1, 128)
    # the QA decode write: f32 rows [1, 5, 64] into the bf16 [1, 5, 4608, 64] caches
    qk, qv = randn(1, 5, 64), randn(1, 5, 64)
    qa_len = torch.tensor([3071], dtype=torch.int32, device=dev)

    def qa_scatter():
        """The block the QA model ran before the pair kernel took its rows."""
        slot = torch.arange(1, device=dev)
        p = qa_len.long()
        kc[slot, :, p, :] = qk.to(bf16)
        vc[slot, :, p, :] = qv.to(bf16)

    # rows 7-12: the so400m layer at 8 frames
    x, w = int8(5888, 1152), int8(6144, 1152)
    scale, bias = torch.full((6144,), 1e-4, device=dev), torch.zeros(6144, device=dev)
    h = randn(5888, 1152, dtype=bf16)
    g, b = torch.ones(1152, device=dev), torch.zeros(1152, device=dev)
    qkv, packed = randn(5888, 6144, dtype=bf16), randn(5888, 3456, dtype=bf16)
    att = dict(batch=8, seq_pad=736, kv_len=729, num_heads=16, sm_scale=72 ** -0.5)
    enc_mask = (torch.arange(736, device=dev) < 729)[None, None, None, :]
    qd16 = qd.to(bf16)[:, :, None, :]
    qc16 = qc.to(bf16)
    calls = {
        # the pieces of a launch, down to its floors
        "ctypes call, no argument (gvl_decode_attention_split)":
            lib.gvl_decode_attention_split,
        "empty kernel launch, ctypes, stream handle given":
            lambda: empty_launch(stream),
        "empty kernel launch with the raw stream handle looked up":
            lambda: empty_launch(_build.stream_handle(index)),
        "stream handle before: torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream handle now: torch._C._cuda_getCurrentRawStream":
            lambda: _build.stream_handle(index),
        "device check before, 3 tensors": lambda: _require_cuda_before("x", cache, row, pos),
        "device check now, 3 tensors": lambda: _build.require_cuda("x", cache, row, pos),
        "data_ptr() of one tensor": cache.data_ptr,
        "gvl_cache_append through ctypes, 11 arguments, pointers given":
            (lambda a=cache.data_ptr(), r=row.data_ptr(), p=pos.data_ptr():
             lib.gvl_cache_append(a, None, r, None, p, 1, 8, 1024, 256, 0, stream)),
        # the twelve wrappers at their phase-2 shapes, and their yardsticks
        "1 flash_attention": lambda: flash_attention(q, k, v, causal=True),
        "1 library: SDPA f32 causal": lambda: yard.library_flash(q, k, v, True),
        "2 decode_attention": lambda: decode_attention(qd, kc, vc, live),
        "2 library: SDPA bf16 over the live prefix": lambda: yard.library_decode(
            qd16, kc[:, :, :3072], vc[:, :, :3072]),
        "3 cache_append": lambda: cache_append(cache, row, pos),
        "3 library: index_copy_": lambda: cache.index_copy_(2, pos_long, row3),
        "3 pair: cache_append_kv, 8B rows":
            lambda: cache_append_kv(cache, cache_v, row, row_v, pos),
        "3 pair library: 2 x index_copy_": lambda: (cache.index_copy_(2, pos_long, row3),
                                                    cache_v.index_copy_(2, pos_long, row3_v)),
        "3 pair: cache_append_kv, QA f32 rows into bf16":
            lambda: cache_append_kv(kc, vc, qk, qv, qa_len),
        "3 pair, what it replaced: the QA scatter block": qa_scatter,
        "4 decode_attention_stacked": lambda: decode_attention_stacked(q4, k_all, v_all, lens4, 2),
        "4 library: SDPA bf16 masked": lambda: yard.library_masked(
            q4[:, :, None, :], k_all[2], v_all[2], st_mask),
        "5 cache_append_stacked": lambda: cache_append_stacked(k_all, rows4, pos4, 2),
        "5 library: index_copy_": lambda: k_rows2.index_copy_(0, flat, new_k4),
        "5 pair: cache_append_stacked_kv":
            lambda: cache_append_stacked_kv(k_all, v_all, rows4, rows4_v, pos4, 2),
        "5 pair library: 2 x index_copy_": lambda: (k_rows2.index_copy_(0, flat, new_k4),
                                                    v_rows2.index_copy_(0, flat, new_v4)),
        "6 chunk_attention": lambda: chunk_attention(qc, kc, vc, start),
        "6 library: SDPA bf16 masked": lambda: yard.library_masked(
            qc16, kc[:, :, :2048], vc[:, :, :2048], chunk_mask),
        "7 w8a8_matmul": lambda: qm.w8a8_matmul(x, w, scale, bias),
        "7 library: int8 product + epilogue": lambda: yard.library_int_mm(
            x, w, scale, bias, "none"),
        "8 ln_quant": lambda: qm.ln_quant(h, g, b, 40.0),
        "8 library: layer norm + quantize": lambda: yard.library_layer_norm_quant(
            h, g, b, 40.0),
        "9 attention_fused_qkv": lambda: qm.attention_fused_qkv(
            qkv, dh_pad=128, out_scale_inv=40.0, **att),
        "9 library: SDPA bf16 masked": lambda: yard.library_encoder_attention(
            qkv, 8, 736, 16, 128, enc_mask),
        "10 attention_packed_multihead": lambda: qm.attention_packed_multihead(
            packed, head_dim=72, out_scale_inv=40.0, **att),
        "10/12 library: SDPA bf16 masked": lambda: yard.library_encoder_attention(
            packed, 8, 736, 16, 72, enc_mask),
        "11 quant_static": lambda: qm.quant_static(h, 20.0),
        "11 library: quantize in torch": lambda: yard.library_quant(h, 20.0),
        "12 attention_qkv_packed": lambda: qm.attention_qkv_packed(packed, head_dim=72, **att),
    }
    out = {}
    for name, fn in calls.items():
        out[name] = host_and_event_us(fn)
        print(f"{name}: {out[name]}", flush=True)
    return out


def main() -> dict:
    dev = resolve_device("cuda")
    print(yard.nvidia_smi(), flush=True)
    return {"device": torch.cuda.get_device_name(0), "launch": launch_costs(dev)}


if __name__ == "__main__":
    print(json.dumps(main()))
