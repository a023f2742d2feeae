"""Ablations of the redesigned kernels, on the card.

    python -m gvl_tpu_torch.kernel_ablation [--only SOURCE ...]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
For each redesigned source (the tensor-core attention kernels
``csrc/encoder_attention.cu``, ``chunk_attention.cu``,
``decode_attention.cu``, ``flash_attention.cu``; B9's ``int8_scores`` mode
``encoder_attention_int8.cu``; the ``wgmma`` int8 product
``w8a8_matmul.cu``; the streaming LayerNorm-quantize ``ln_quant.cu``) it
builds the committed source and copies of it with one design choice undone
(a text edit, :data:`VARIANTS`), each into its own library under
``gvl_tpu_torch/_build/ablation/`` (one nvcc per library, all started
together), then calls their C entry points in turns (every variant, then
every variant again in reverse order; the lower time is kept) with CUDA
events around back-to-back calls, at the so400m frames shape (B9 in both
modes, B10; 8 frames, Sp 736), the chunk, decode and prefill shapes of the served QA
model and 8B geometry, the bf16 so400m tower's attention, and the fused
tower's int8 products (each at two tile widths) and LayerNorm-quantize.
Each output is held against the plain version: int8 outputs by their
largest step and the share of elements that differ, the others by their
largest absolute difference.  Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from gvl_tpu_torch.ops import _build

# source -> variant -> [(text in the committed source, its replacement)]
VARIANTS = {
    "encoder_attention.cu": {
        "one m-tile per warp (64-row blocks)": [
            ("constexpr int kParts = sizeof(T) == 4 ? 2 : 1, kM = 3 - kParts;",
             "constexpr int kParts = sizeof(T) == 4 ? 2 : 1, kM = 1;")],
        "exp2f or expf chosen around every key": [
            ("      if (use_exp2)\n        softmax([](float x) { return exp2_ftz(x); });\n"
             "      else\n        softmax([](float x) { return expf(x); });",
             "      softmax([&](float x) { return use_exp2 ? exp2f(x) : expf(x); });")],
        "runtime tests around the products": [
            ("    for (int kk = 0; kk < kD / 16; ++kk) {\n      unsigned qa",
             "    for (int kk = 0; kk < kD / 16; ++kk) {\n"
             "      if (kk * 16 >= ((dh + 15) & ~15)) continue;\n      unsigned qa"),
            ("            mma_bf16(o[mt][2 * np + 1], pa[mt], vb[2], vb[3]);\n          }",
             "            if (2 * np + 1 < n_vt) mma_bf16(o[mt][2 * np + 1], pa[mt], vb[2], vb[3]);"
             "\n          }")],
    },
    "encoder_attention_int8.cu": {
        "__fdiv_rn in the epilogue (its slow path at every zero numerator)": [
            ("      return y == 0.f ? y : __fmaf_rn(__fmaf_rn(-d[r], q, y), rd[r], q);",
             "      return __fdiv_rn(y, d[r]);")],
        "p v and the next q k^T waited for apart": [
            ("      wgmma_commit();\n      if (i > 0) issue_qk(i - 1);",
             "      wgmma_commit();\n      wait_all();\n      if (i > 0) issue_qk(i - 1);")],
        "int8 out by 2-byte stores (no staging)": [
            ("    if constexpr (kQuantOut) {\n      // the int8 rows go through",
             "    if constexpr (false) {\n      // the int8 rows go through"),
            ("            store_pair<T, false>(", "            store_pair<T, kQuantOut>("),
            ("      if (!kQuantOut && i == 0 && lane == 0)",
             "      if (i == 0 && lane == 0)")],
        "a block per query tile (each loads its head's K8)": [
            ("  const int split = max(1, min(n_qt, sms / (batch * heads)));",
             "  const int split = n_qt;")],
        "2 V stages": [("constexpr int kVStages = 3;", "constexpr int kVStages = 2;")],
        "pre-pass: 4 blocks a slab": [("constexpr int kPrepSplit = 8; ", "constexpr int kPrepSplit = 4; ")],
        "body launched after the pre-pass (no programmatic dependent launch)": [
            ("  serial[0].val.programmaticStreamSerializationAllowed = 1;",
             "  serial[0].val.programmaticStreamSerializationAllowed = 0;")],
    },
    "chunk_attention.cu": {
        "one key group (4 warps, 4-stage ring)": [
            ("constexpr int kGroups = 2;", "constexpr int kGroups = 1;"),
            ("constexpr int kStages = D == 64 ? 3 : 2;", "constexpr int kStages = D == 64 ? 4 : 3;")],
        "a branch around every exp": [
            ("          const float ex = expf(s[n][e] - m[e >> 1]);\n"
             "          const float p = s[n][e] == kNegInf ? 0.f : ex;",
             "          const float p = s[n][e] == kNegInf ? 0.f : expf(s[n][e] - m[e >> 1]);")],
        "row tiles in order (longest last)": [
            ("  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;",
             "  const int r0 = blockIdx.x * kRows;")],
    },
    "decode_attention.cu": {
        "one block per (slot, KV head): no cluster split": [
            ("constexpr int kSplit = 8;", "constexpr int kSplit = 1;")],
        "expf for every weight (not one ex2.approx)": [
            ("        const float ex = exp2_ftz(s[p][g] - m_new);",
             "        const float ex = expf((s[p][g] - m_new) * 0.6931471805599453f);")],
    },
    "flash_attention.cu": {
        "one m-tile per warp": [
            ("struct Tiles<float, 64> { static constexpr int kM = 2,",
             "struct Tiles<float, 64> { static constexpr int kM = 1,"),
            ("struct Tiles<__nv_bfloat16, 128> { static constexpr int kM = 2,",
             "struct Tiles<__nv_bfloat16, 128> { static constexpr int kM = 1,")],
        "one key group at f32 D 64 (4 warps per SM)": [
            ("struct Tiles<float, 64> { static constexpr int kM = 2, kBK = 64, kSt = 2, kGroups = 2; };",
             "struct Tiles<float, 64> { static constexpr int kM = 2, kBK = 64, kSt = 2, kGroups = 1; };")],
        "expf for every weight (not one ex2.approx)": [
            ("          const float ex = exp2_ftz(s[mt][n][e] - m[mt][e >> 1]);",
             "          const float ex = expf((s[mt][n][e] - m[mt][e >> 1]) * 0.6931471805599453f);")],
    },
    "w8a8_matmul.cu": {
        "2 stages": [("static constexpr int kStages = BN == 256 ? 3 : 4;",
                      "static constexpr int kStages = 2;")],
        "3 stages at every width": [("static constexpr int kStages = BN == 256 ? 3 : 4;",
                                     "static constexpr int kStages = 3;")],
        "4-byte stores straight from the fragment (no staging; whole tiles only)": [
            ("    unsigned char* lo = out_rows + r0 * T::kOutLd;\n"
             "    unsigned char* hi = lo + 8 * T::kOutLd;",
             "    unsigned char* lo = static_cast<unsigned char*>(out) + "
             "((size_t)(m0 + half * 64 + r0) * n_cols + n0) * kOutBytes;\n"
             "    unsigned char* hi = lo + (size_t)8 * n_cols * kOutBytes;"),
            ("      for (int u = tid; u < 64 * kUnits; u += 128) {",
             "      for (int u = tid; u < 0; u += 128) {")],
        "__fdiv_rn around every GELU division": [
            ("        for (int e = 0; e < 4; ++e) y[e] = div_ge1(y[e], gelu_denominator(y[e]));",
             "        for (int e = 0; e < 4; ++e) y[e] = __fdiv_rn(y[e], gelu_denominator(y[e]));")],
    },
    "ln_quant.cu": {
        "gamma and beta re-read per row": [
            ("      load_f32<float, 8>(sg + c, gb[0]);\n      load_f32<float, 8>(sb + c, gb[1]);",
             "      load_f32<float, 8>(gamma + c, gb[0]);\n      load_f32<float, 8>(beta + c, gb[1]);")],
        "one row per warp, no prefetch (a grid over every row)": [
            ("  const int blocks = want < last_blocks ? want : last_blocks;",
             "  const int blocks = want;")],
    },
}
BASE = "as committed"


def edited(source: str, edits: list[tuple[str, str]]) -> str:
    """The text of csrc/``source`` with ``edits`` applied; each edited text
    must occur exactly once."""
    text = (_build.CSRC_DIR / source).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{source}: the text to edit occurs {text.count(old)} times:"
                             f"\n{old}")
        text = text.replace(old, new)
    return text


def build_variant(source: str, name: str, edits) -> ctypes.CDLL:
    """One source with ``edits``, compiled alone into a shared library
    and loaded."""
    slug = "".join(c if c.isalnum() else "_" for c in name)[:40]
    out = _build.BUILD_DIR / "ablation" / f"{Path(source).stem}-{slug}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, out)
    (out / source).write_text(edited(source, edits))
    lib_path = out / "lib.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(out / source)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    for fn, sig in _build._SIGNATURES.items():
        if sig and hasattr(lib, fn):
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def time_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def encoder_cases(dev):
    from gvl_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for label, dh in (("B9 frames [5888,3x16x128] -> int8", 128),
                      ("B10 frames [5888,3x16x72] -> int8", 72)):
        qkv = torch.randn(5888, 48 * dh, generator=gen, device=dev).to(torch.bfloat16)
        if dh == 128:
            qkv.view(5888, 48, 128)[..., 72:] = 0      # heads padded as served
        kw = dict(batch=8, seq_pad=736, kv_len=729, num_heads=16, sm_scale=72 ** -0.5,
                  out_scale_inv=40.0)
        want = (qm.attention_fused_qkv_reference(qkv, dh_pad=128, **kw) if dh == 128 else
                qm.attention_packed_multihead_reference(qkv, head_dim=72, **kw))
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(lib, qkv=qkv, out=out, dh=dh):
            err = lib.gvl_encoder_attention(qkv.data_ptr(), out.data_ptr(), 8, 16, 736, 729,
                                            dh, 72 ** -0.5 * qm.LOG2E, 1, 1, 40.0, 1, stream)
            if err:
                raise RuntimeError(f"gvl_encoder_attention returned {err}")

        def check(out=out, want=want):
            diff = (out.int() - want.int()).abs()
            return f"int8 max step {diff.max().item()}, share {(diff > 0).float().mean().item():.1e}"

        cases[label] = (run, check)
    return cases


def int8_cases(dev):
    from gvl_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(5888, 48 * 128, generator=gen, device=dev).to(torch.bfloat16)
    qkv.view(5888, 48, 128)[..., 72:] = 0      # heads padded as served
    want = qm.attention_fused_qkv_reference(
        qkv, batch=8, seq_pad=736, kv_len=729, num_heads=16, dh_pad=128, sm_scale=72 ** -0.5,
        int8_scores=True, out_scale_inv=40.0)
    out = torch.empty_like(want)
    scratch = torch.empty(3 * 8 * 16 * 768 * 128, dtype=torch.int8, device=dev)
    amax = torch.empty(8, 16, 3, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib):
        err = lib.gvl_encoder_attention_int8(qkv.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                             amax.data_ptr(), 8, 16, 736, 729, 128,
                                             72 ** -0.5 * qm.LOG2E, 1, 40.0, 736, 1, stream)
        if err:
            raise RuntimeError(f"gvl_encoder_attention_int8 returned {err}")

    def check():
        diff = (out.int() - want.int()).abs()
        return f"int8 max step {diff.max().item()}, share {(diff > 0).float().mean().item():.1e}"

    return {"B9 int8_scores frames [5888,3x16x128] -> int8": (run, check)}


def chunk_cases(dev):
    from gvl_tpu_torch.ops.decode_attention import chunk_attention_reference

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for label, hq, hkv, seq, s_max, d, dtype, start in (
            ("QA admission: f32 q [1,10,2048,64] at 0", 10, 5, 2048, 4608, 64,
             torch.float32, 0),
            ("QA session delta: f32 q [1,10,128,64] at 1200", 10, 5, 128, 4608, 64,
             torch.float32, 1200),
            ("QA speculative verify: f32 q [1,10,5,64] at 1517", 10, 5, 5, 4608, 64,
             torch.float32, 1517),
            ("8B admission: bf16 q [1,32,128,128] at 0", 32, 8, 128, 1024, 128,
             torch.bfloat16, 0)):
        q = torch.randn(1, hq, seq, d, generator=gen, device=dev).to(dtype)
        kc = torch.randn(1, hkv, s_max, d, generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn(1, hkv, s_max, d, generator=gen, device=dev).to(torch.bfloat16)
        starts = torch.tensor([start], dtype=torch.int32, device=dev)
        want = chunk_attention_reference(q, kc, vc, starts)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(lib, q=q, kc=kc, vc=vc, starts=starts, out=out, hq=hq, hkv=hkv, seq=seq,
                s_max=s_max, d=d):
            err = lib.gvl_chunk_attention(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                          starts.data_ptr(), out.data_ptr(), 1, hq, hkv, seq,
                                          s_max, d, 1.0 / math.sqrt(d),
                                          _build.DTYPE_CODES[q.dtype], stream)
            if err:
                raise RuntimeError(f"gvl_chunk_attention returned {err}")

        def check(out=out, want=want):
            return f"max abs err {(out.float() - want.float()).abs().max().item():.3g}"

        cases[label] = (run, check)
    return cases


def decode_cases(dev):
    from gvl_tpu_torch.ops.decode_attention import decode_attention_reference

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for label, batch, hq, hkv, s_max, d, dtype, lens in (
            ("QA decode: f32 q [1,10,64], bf16 cache [1,5,4608,64], length 3072",
             1, 10, 5, 4608, 64, torch.float32, [3072]),
            ("8B decode: bf16 q [4,32,128], bf16 cache [4,8,1024,128], lengths 129-144",
             4, 32, 8, 1024, 128, torch.bfloat16, [129, 134, 140, 144])):
        q = torch.randn(batch, hq, d, generator=gen, device=dev).to(dtype)
        kc, vc = (torch.randn(batch, hkv, s_max, d, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        want = decode_attention_reference(q, kc, vc, lengths)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(lib, q=q, kc=kc, vc=vc, lengths=lengths, out=out, batch=batch, hq=hq,
                hkv=hkv, s_max=s_max, d=d):
            err = lib.gvl_decode_attention(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                           lengths.data_ptr(), out.data_ptr(), batch, hq,
                                           hkv, s_max, d, 1.0 / math.sqrt(d),
                                           _build.DTYPE_CODES[q.dtype], stream)
            if err:
                raise RuntimeError(f"gvl_decode_attention returned {err}")

        def check(out=out, want=want):
            return f"max abs err {(out.float() - want.float()).abs().max().item():.3g}"

        cases[label] = (run, check)
    return cases


def flash_cases(dev):
    from gvl_tpu_torch.ops.attention import attention_reference

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for label, batch, hq, hkv, seq, d, dtype, causal in (
            ("QA prefill: f32 [1,10,4096,64], 5 KV heads, causal",
             1, 10, 5, 4096, 64, torch.float32, True),
            ("so400m tower: bf16 [8,16,729,80] (72 padded)", 8, 16, 16, 729, 80,
             torch.bfloat16, False),
            ("8B prefill: bf16 [1,32,128,128], 8 KV heads, causal", 1, 32, 8, 128, 128,
             torch.bfloat16, True)):
        q = torch.randn(batch, hq, seq, d, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(batch, hkv, seq, d, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        want = attention_reference(q, k, v, causal=causal)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(lib, q=q, k=k, v=v, out=out, batch=batch, hq=hq, hkv=hkv, seq=seq, d=d,
                causal=causal):
            err = lib.gvl_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          out.data_ptr(), batch, hq, hkv, seq, seq, d, seq,
                                          int(causal), 1.0 / math.sqrt(d),
                                          _build.DTYPE_CODES[q.dtype], stream)
            if err:
                raise RuntimeError(f"gvl_flash_attention returned {err}")

        def check(out=out, want=want):
            return f"max abs err {(out.float() - want.float()).abs().max().item():.3g}"

        cases[label] = (run, check)
    return cases


def w8a8_cases(dev):
    from gvl_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for label, k, n, epilogue, block_n in (
            ("qkv [5888,1152]x[6144,1152] -> bf16, BN 256", 1152, 6144, "none", 256),
            ("qkv [5888,1152]x[6144,1152] -> bf16, BN 128", 1152, 6144, "none", 128),
            ("o-projection [5888,2048]x[1152,2048] + residual, BN 144", 2048, 1152,
             "residual", 144),
            ("o-projection [5888,2048]x[1152,2048] + residual, BN 128", 2048, 1152,
             "residual", 128),
            ("fc1 [5888,1152]x[4352,1152] -> GELU int8, BN 256", 1152, 4352, "gelu_quant",
             256)):
        x = torch.randint(-127, 128, (5888, k), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        scale = (torch.rand(n, generator=gen, device=dev) + 0.5) * (3.0 / (5376 * k ** 0.5))
        bias = torch.randn(n, generator=gen, device=dev) * 0.1
        res = torch.randn(5888, n, generator=gen, device=dev).to(torch.bfloat16)
        kw = dict(epilogue=epilogue, out_scale_inv=37.5 if epilogue == "gelu_quant" else None,
                  residual=res if epilogue == "residual" else None)
        want = qm.w8a8_matmul_reference(x, w, scale, bias, **kw)
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(lib, x=x, w=w, scale=scale, bias=bias, res=res, out=out, k=k, n=n,
                epilogue=epilogue, block_n=block_n):
            err = lib.gvl_w8a8_matmul(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                                      bias.data_ptr(), res.data_ptr(), out.data_ptr(), 5888,
                                      n, k, qm.EPILOGUES[epilogue], 37.5, 1, block_n, stream)
            if err:
                raise RuntimeError(f"gvl_w8a8_matmul returned {err}")

        if epilogue == "gelu_quant":
            def check(out=out, want=want):
                diff = (out.int() - want.int()).abs()
                return (f"int8 max step {diff.max().item()}, share "
                        f"{(diff > 0).float().mean().item():.1e}")
        else:
            def check(out=out, want=want):
                return f"max abs err {(out.float() - want.float()).abs().max().item():.3g}"

        cases[label] = (run, check)
    return cases


def ln_quant_cases(dev):
    from gvl_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for label, rows in (("frames bf16 [5888,1152] -> int8", 5888),
                        ("regions bf16 [1536,1152] -> int8", 1536)):
        x = (torch.randn(rows, 1152, generator=gen, device=dev) * 2.0).to(torch.bfloat16)
        g = torch.rand(1152, generator=gen, device=dev) + 0.5
        b = torch.randn(1152, generator=gen, device=dev) * 0.1
        want = qm.ln_quant_reference(x, g, b, 40.0)
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(lib, x=x, g=g, b=b, out=out, rows=rows):
            err = lib.gvl_ln_quant(x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   rows, 1152, 1e-6, 40.0, 1, stream)
            if err:
                raise RuntimeError(f"gvl_ln_quant returned {err}")

        def check(out=out, want=want):
            diff = (out.int() - want.int()).abs()
            return (f"int8 max step {diff.max().item()}, share "
                    f"{(diff > 0).float().mean().item():.1e}")

        cases[label] = (run, check)
    return cases


CASES = {"encoder_attention.cu": encoder_cases, "encoder_attention_int8.cu": int8_cases,
         "chunk_attention.cu": chunk_cases,
         "decode_attention.cu": decode_cases, "flash_attention.cu": flash_cases,
         "w8a8_matmul.cu": w8a8_cases, "ln_quant.cu": ln_quant_cases}


def main(only: tuple[str, ...] = ()) -> dict:
    """Every source's variants, or those of the sources in ``only``."""
    dev = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: no CUDA device; it runs on the card only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    result = {"device": smi}
    sources = [source for source in CASES if not only or source in only]
    builds = [(source, name, edits) for source in sources
              for name, edits in [(BASE, [])] + list(VARIANTS[source].items())]
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        built = list(pool.map(lambda b: build_variant(*b), builds))
    libraries = {(source, name): lib for (source, name, _), lib in zip(builds, built)}
    for source in sources:
        cases = CASES[source](dev)
        libs = {name: lib for (src, name), lib in libraries.items() if src == source}
        table = {}
        for label, (run, check) in cases.items():
            times = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                times[name].append(time_ms(lambda: run(libs[name])))
            checks = {}
            for name, lib in libs.items():
                run(lib)
                torch.cuda.synchronize()
                checks[name] = check()
            table[label] = {name: {"ms": min(t), "check": checks[name]}
                            for name, t in times.items()}
            print(f"{source} {label}: " + ", ".join(
                f"{name} {min(t):.4f} ms ({checks[name]})" for name, t in times.items()),
                flush=True)
        result[source] = table
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="+", default=(), choices=sorted(CASES),
                        help="ablate these sources only")
    print(json.dumps(main(tuple(parser.parse_args().only))))
