#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gvl_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
``nvcc``.  Phases, each printing its elapsed time:

0. device: the card's name and power limit (``nvidia-smi``), PyTorch's version;
1. build: one ``nvcc`` per ``gvl_tpu_torch/csrc/*.cu``, started together,
   then one link;
2. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the served models give it, with the tolerance stated; then each
   kernel's time, its plain version's, one PyTorch library call's that
   computes the same function (a yardstick only) and the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak of the units
   the kernel computes on, named in ``bound_peak``); the append kernel's
   pair forms (K and V in one launch, f32 rows cast into a bf16 cache in
   the kernel) are held bit for bit against their plain versions and timed
   against the same two writes made by other means (``pairs`` of rows 3
   and 5), the flash kernel also at the bf16 SigLIP so400m tower's
   attention and its MAP head (``lines`` of row 1), and the int8 product
   at all four products of a fused so400m layer and the regions' qkv
   (``lines`` of its row), after ``cuobjdump`` shows that its built kernels
   issue warpgroup products (IGMMA) and no ``mma.sync`` (IMMA);
3. the in-repo QA model (``outputs/qa_lm``, real weights) behind
   ``create_qa_backend``: held-out accuracy through ``evaluate_qa_lm`` (n 40,
   seed 1234) against ``outputs/qa_lm/metrics.json``, the CUDA launches of
   one decode step (profiler), the same 40 samples through the plain path
   on the card, and one chat through ``Qwen3ChatBackend.stream``;
4. the 8B decoder's layer geometry at depth 4, random bf16 weights: kernel
   path against plain path (prefill and first-step logits), then 16 greedy
   steps;
5. the QA model served through ``ContinuousBatchingEngine`` (4 slots, the
   same 40 prompts): accuracy, answers against phase 3's, aggregate decode
   tokens/s and time to first token;
6. ``EngineServer`` behind ``create_server`` on 127.0.0.1: 4 concurrent
   ``POST /generate`` against ``generate_many``, a 2-turn ``POST /chat``
   whose second turn prefills only the delta, ``GET /metrics``;
7. ``Qwen3ChatSession`` turns 2 and 3 and ``PromptLookupEngine`` on 8
   prompts against a fresh ``Qwen3Engine``;
8. the 8B geometry with ``scan_layers`` (weights stacked from phase 4's):
   kernel path against plain path and an f32 evaluation, then 4 slots x 16
   greedy steps through the batching engine against the unrolled engine;
9. the region semantic encoder on the fused W8A8 SigLIP so400m tower
   (random weights, seed 0): ``SigLIPSemanticEncoder.encode_images_batch``
   on 8 seeded 384 x 384 frames and ``encode_masked_regions`` on one frame
   with 16 masks (128 canvas), each against the plain path of the same
   fused tree and against the bf16 ``TorchSigLIPBackend`` on the same
   weights (pooled cosine), with images/s and regions/s; then regions of
   three more seeded frames and mask layouts against the bf16 tower;
10. the packed-head variant of the fused tower against the padded one;
11. perception: the ``qa_lm`` arm's encoders at their trained geometry with
    seeded random weights (``gvl_tpu_torch.perception.encoders``), served
    once through their entry points with the launches counted (the
    retriever over 64 event texts and 64 queries, the segmenter's tracker
    on 32 synthetic 320 x 568 gameplay frames x 4 concepts, the OCR engine
    on 8 HUD frames, the audio processor's event detection on 8 s and its
    transcription of 4 ASR windows of 6 s), then each against its plain
    path: the retriever's embeddings and top-1, the segmenter's mask
    logits, flipped mask cells and scores, the ASR's encoder states and
    greedy tokens (the flash kernel against its plain version on the
    card), the OCR nets' logits and the event net's probabilities (no
    flash kernel: the card against the CPU on the same weights); wall ms
    per call of each encoder.

Kernel launch counts are zeroed just before each served run (the kernel
path of phases 3 to 11) and read just after it; each run must have launched
every kernel of its path, and as many appends as decode attentions (a
decode step writes each layer's K and V with one launch).
``quant_static`` and ``attention_qkv_packed`` lie on no served path (as in
the JAX package): phase 2 alone checks them.  The last two lines are a
JSON object of per-kernel numbers and ``{"ok": true, "device": ...}``.  Any
failed check raises, so the exit code is not 0; a watchdog turns a hang
into a traceback and an exit.  No JAX and nothing of ``gvl_tpu`` is used.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
QA_CKPT = REPO / "outputs" / "qa_lm"
WATCHDOG_S = 1100        # below the 1200 s the run is allowed
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12,
              "torch.int8": 1979e12}   # dense tensor-core peaks
PEAK_NAMES = {"torch.float32": "f32 CUDA cores 67 TFLOP/s",
              "torch.bfloat16": "bf16 tensor cores 989 TFLOP/s",
              "torch.int8": "int8 tensor cores 1979 TOP/s"}
QA_SEED, QA_SAMPLES = 1234, 40
QA_ACCURACY_SLACK = 0.075  # 3 of 40 answers
QA_MIN_AGREE = 38          # kernel vs plain path answers, of 40
QA_SLOTS, QA_MAX_NEW = 4, 48   # batching engine slots; evaluate_qa_lm's budget
LOOKUP_PROMPTS = 8
# session turns and prompt-lookup streams (10 in all) that may differ from a
# fresh Qwen3Engine: chunk and flash prefill round differently into the bf16
# cache, which can flip a near-tied argmax
STREAM_SLACK = 1
F32_TOL = (1e-4, 1e-4)     # (atol, rtol): f32 sums in another order
BF16_TOL = (2e-2, 2e-2)    # a few units of bf16's 2**-8 relative precision
# decode attention, whose outputs are weighted means over up to thousands of
# keys, far below 2e-2 in size: atol a share of each slot's largest |value|,
# rtol two bf16 steps.  An exact evaluation stays well inside this limit,
# and one lost key, a lost warp tile or a doubled warp partial goes past it
# at the timed shapes (tests/test_torch_attention_checks.py)
DECODE_TOL = (2 ** -8, 2 ** -6)   # (atol over max |want| of the slot, rtol)
# 8B logits: the bf16 kernel path may stray from an f32 evaluation of the
# same weights by at most this multiple of the bf16 plain path's own error
BF16_ERR_RATIO = 1.5
# int8 outputs: at most one step apart, on at most this share of elements
# (exp2, rsqrt and f32 sums in another order move values across a boundary)
INT8_FLIP_SHARE = 1e-3
SEMANTIC_SEED, SEMANTIC_FRAMES, SEMANTIC_MASKS = 0, 8, 16
REGION_SEEDS = (1, 2, 3)    # more frames and mask layouts, fused vs bf16
# pooled cosine: kernel path against the plain path of the same fused
# tree; fused tower against the bf16 tower on the same weights (the JAX
# package records >= 0.9998 there, bench.py:66-68); packed heads against
# padded heads
COS_KERNEL_PLAIN, COS_FUSED_BF16, COS_PACKED_PADDED = 0.9995, 0.999, 0.999
# fused kernels per forward of the 27-layer tower
FUSED_LAUNCHES = {"w8a8_matmul": 4 * 27, "ln_quant": 2 * 27}
# phase 11: the qa_lm arm's encoders at their trained geometry, seeded
# random weights; 32 frames (the arm's max_frames) x 4 concepts, 64
# retrieval texts over a 64-entry index, 8 HUD frames, 8 s of audio for
# the event net, 4 ASR windows of 6 s
PERCEPTION_SEED, PERCEPTION_FRAMES, RETRIEVAL_TEXTS, OCR_FRAMES = 11, 32, 64, 8
EVENT_SECONDS, ASR_CHUNKS = 8, 4
RETRIEVER_TOL = 1e-4        # unit embeddings, f32 (B1's f32 route: ~2**-16)
MASK_LOGIT_SHARE = 1e-3     # mask logits: max abs err per unit of max |logit|
MASK_FLIP_SHARE = 1e-3      # mask cells on the other side of the threshold
SCORE_TOL = 1e-4
OCR_LOGIT_SHARE = 1e-3      # card against the CPU, same weights
EVENT_PROB_TOL = 1e-4       # card against the CPU, same weights
ASR_STATE_TOL = 1e-4

_T0 = time.perf_counter()


def log(phase: str, message: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {phase}: {message}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def decode_tol(want) -> tuple:
    """DECODE_TOL for a decode output ``want`` [B, Hq, D], as assert_close's
    ``(atol, rtol)`` with atol a tensor [B, 1, 1]: one limit per slot."""
    share, rtol = DECODE_TOL
    return share * want.float().abs().amax(dim=(1, 2), keepdim=True), rtol


def assert_close(what: str, got, want, tol: tuple) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere (atol a
    number, or a tensor that broadcasts against want); returns max |got - want|."""
    atol, rtol = tol
    err = max_err(got, want)
    diff = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    ok = (diff - limit).max().item() <= 0 and math.isfinite(err)
    share = (diff / limit.clamp_min(1e-30)).max().item()
    shown = atol if isinstance(atol, float) else f"<= {atol.max().item():.3g}"
    log("kernels", f"{what}: max abs err {err:.3g}, {share:.2g} of the limit "
        f"(atol {shown}, rtol {rtol}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return err


def time_ms(fn, iters: int = 20) -> float:
    import torch

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


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str, str]:
    """The least time for the work: (ms, what bounds it, the peak it is
    taken at), the operations at the peak of ``dtype``'s units (f32: CUDA
    cores; bf16, int8: tensor cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", f"HBM {HBM_BYTES_PER_S / 1e12:g} TB/s"
    return t_ops * 1e3, "operations", PEAK_NAMES[str(dtype)]


def attention_pairs(seq_q: int, seq_k: int, causal: bool, kv_len) -> int:
    """(query, key) pairs that are not masked."""
    live = seq_k if kv_len is None else min(kv_len, seq_k)
    if not causal:
        return seq_q * live
    return sum(min(r + 1, live) for r in range(seq_q))


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def library_flash(q, k, v, causal):
    """Yardstick only: PyTorch's fused attention on the same inputs."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def library_decode(q4, k, v):
    """Yardstick only: PyTorch's fused attention over the live prefix."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q4, k, v, enable_gqa=True)


def library_masked(q, k, v, mask):
    """Yardstick only: PyTorch's fused attention with an explicit mask
    (True where a key is attended)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def check_kernels(dev) -> list[dict]:
    import torch

    from gvl_tpu_torch.ops.attention import attention_reference, flash_attention
    from gvl_tpu_torch.ops.cache_update import (
        cache_append,
        cache_append_kv,
        cache_append_kv_reference,
        cache_append_reference,
        cache_append_stacked,
        cache_append_stacked_kv,
        cache_append_stacked_kv_reference,
        cache_append_stacked_reference,
    )
    from gvl_tpu_torch.ops.decode_attention import (
        chunk_attention,
        chunk_attention_reference,
        decode_attention,
        decode_attention_reference,
        decode_attention_stacked,
        decode_attention_stacked_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # flash_attention: QA prefill buckets (f32, D 64, 10/5 heads) and the
    # 8B geometry's 128-token prefill (bf16, D 128, 32/8 heads)
    flash_cases = [
        ("QA f32 S128 causal", 10, 5, 128, 64, torch.float32, True, None),
        ("QA f32 S4096 causal", 10, 5, 4096, 64, torch.float32, True, None),
        ("QA f32 S1024 kv_len 1000 causal", 10, 5, 1024, 64, torch.float32, True, 1000),
        ("8B bf16 S128 causal", 32, 8, 128, 128, torch.bfloat16, True, None),
    ]
    flash_err, flash_in = 0.0, None
    for name, hq, hkv, seq, d, dtype, causal, kv_len in flash_cases:
        q = randn(1, hq, seq, d, dtype=dtype)
        k, v = randn(1, hkv, seq, d, dtype=dtype), randn(1, hkv, seq, d, dtype=dtype)
        got = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        want = attention_reference(q, k, v, causal=causal, kv_len=kv_len)
        torch.cuda.synchronize()
        err = assert_close(f"flash_attention {name}", got, want,
                           F32_TOL if dtype == torch.float32 else BF16_TOL)
        if name == "QA f32 S4096 causal":   # the QA prefill's usual bucket
            flash_err, flash_in = err, (q, k, v, causal, kv_len)

    # decode_attention: 4 slots with lengths [1, 7, 513, S_max], at the QA
    # geometry (f32 query over a bf16 cache) and the 8B geometry (bf16)
    for name, hq, hkv, s_max, d, qdtype in [
        ("QA f32 q / bf16 cache", 10, 5, 4608, 64, torch.float32),
        ("8B bf16", 32, 8, 1024, 128, torch.bfloat16),
    ]:
        q = randn(4, hq, d, dtype=qdtype)
        kc = randn(4, hkv, s_max, d, dtype=torch.bfloat16)
        vc = randn(4, hkv, s_max, d, dtype=torch.bfloat16)
        lengths = torch.tensor([1, 7, 513, s_max], dtype=torch.int32, device=dev)
        got = decode_attention(q, kc, vc, lengths)
        want = decode_attention_reference(q, kc, vc, lengths)
        torch.cuda.synchronize()
        assert_close(f"decode_attention {name} lengths {lengths.tolist()}", got,
                     want, decode_tol(want))

    # cache_append: in place, the written rows right, every other row intact
    # (4 slots here; one slot at the 8B decode's shape where it is timed)
    cache = randn(4, 8, 1024, 128, dtype=torch.bfloat16)
    new = randn(4, 8, 128, dtype=torch.bfloat16)
    pos = torch.tensor([0, 7, 513, 1023], dtype=torch.int32, device=dev)
    checked_append(f"cache_append 8B B4 positions {pos.tolist()}",
                   lambda: cache_append(cache, new, pos),
                   lambda: cache_append_reference(cache, new, pos), [cache])

    # the pair forms (K and V in one launch) on the decode writes: the 8B
    # rows, and the QA model's f32 rows cast into its bf16 caches in the
    # kernel (rows holding bf16 rounding ties, NaN and inf); positions -1
    # and S_max write nothing
    for name, batch, hkv, s_max, d, row_dtype, positions in [
        ("8B B4", 4, 8, 1024, 128, torch.bfloat16, [0, -1, 1023, 1024]),
        ("QA f32 rows into bf16 B1", 1, 5, 4608, 64, torch.float32, [3071]),
        ("QA f32 rows into bf16 B4", 4, 5, 4608, 64, torch.float32, [0, 700, 4607, 4608]),
    ]:
        caches = [randn(batch, hkv, s_max, d, dtype=torch.bfloat16) for _ in range(2)]
        rows = [hard_rows(randn(batch, hkv, d)) if row_dtype == torch.float32
                else randn(batch, hkv, d, dtype=row_dtype) for _ in range(2)]
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        checked_append(f"cache_append_kv {name} positions {positions}",
                       lambda: cache_append_kv(*caches, *rows, pos),
                       lambda: cache_append_kv_reference(*caches, *rows, pos), caches)
    for layer in (0, 3):
        k_all, v_all = (randn(4, 4, 8, 1024, 128, dtype=torch.bfloat16) for _ in range(2))
        rows = [randn(4, 8, 128, dtype=torch.bfloat16) for _ in range(2)]
        pos = torch.tensor([0, 7, 1024, 1023], dtype=torch.int32, device=dev)
        checked_append(
            f"cache_append_stacked_kv 8B layer {layer} of 4 positions {pos.tolist()}",
            lambda: cache_append_stacked_kv(k_all, v_all, *rows, pos, layer),
            lambda: cache_append_stacked_kv_reference(k_all, v_all, *rows, pos, layer),
            [k_all, v_all])

    # chunk_attention: the chunks of the served paths, f32 query (QA) or
    # bf16 (8B) over a bf16 cache; row s of slot b sees keys 0 .. start[b] + s
    chunk_err, chunk_in = 0.0, None
    for name, batch, hq, hkv, seq, s_max, d, qdtype, starts in [
        ("QA admission", 1, 10, 5, 2048, 4608, 64, torch.float32, [0]),
        ("QA session delta", 1, 10, 5, 128, 4608, 64, torch.float32, [1200]),
        ("QA speculative verify", 1, 10, 5, 5, 4608, 64, torch.float32, [1517]),
        ("8B admission", 1, 32, 8, 128, 1024, 128, torch.bfloat16, [0]),
        ("QA 4 slots", 4, 10, 5, 64, 4608, 64, torch.float32, [0, 700, 1517, 4544]),
    ]:
        q = randn(batch, hq, seq, d, dtype=qdtype)
        kc = randn(batch, hkv, s_max, d, dtype=torch.bfloat16)
        vc = randn(batch, hkv, s_max, d, dtype=torch.bfloat16)
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        got = chunk_attention(q, kc, vc, start)
        want = chunk_attention_reference(q, kc, vc, start)
        torch.cuda.synchronize()
        err = assert_close(f"chunk_attention {name} q {list(q.shape)} starts {starts}",
                           got, want, BF16_TOL)
        if name == "QA admission":
            chunk_err, chunk_in = err, (q, kc, vc, start)

    # the stacked forms: 8B geometry, 4 slots of mixed lengths, layer 2 of 4
    k_all = randn(4, 4, 8, 1024, 128, dtype=torch.bfloat16)
    v_all = randn(4, 4, 8, 1024, 128, dtype=torch.bfloat16)
    q = randn(4, 32, 128, dtype=torch.bfloat16)
    lengths = torch.tensor([1, 300, 700, 1024], dtype=torch.int32, device=dev)
    want = decode_attention_stacked_reference(q, k_all, v_all, lengths, 2)
    stacked_err = assert_close(
        f"decode_attention_stacked 8B lengths {lengths.tolist()} layer 2",
        decode_attention_stacked(q, k_all, v_all, lengths, 2), want, decode_tol(want))
    new = randn(4, 8, 128, dtype=torch.bfloat16)
    pos = torch.tensor([0, 7, 513, 1023], dtype=torch.int32, device=dev)
    checked_append(f"cache_append_stacked 8B positions {pos.tolist()} layer 2",
                   lambda: cache_append_stacked(k_all, new, pos, 2),
                   lambda: cache_append_stacked_reference(k_all, new, pos, 2), [k_all])

    # times at the main path's shapes; the flash kernel runs q k^T and P V
    # on bf16 tensor cores (f32 split into bf16 hi + lo): every bound of B1
    # is taken at their peak, for one product
    q, k, v, causal, kv_len = flash_in
    pairs = attention_pairs(q.shape[2], k.shape[2], causal, kv_len)
    flash_bound = bound_ms(sum(t.nbytes for t in (q, k, v)) + q.nbytes,
                           4.0 * q.shape[0] * q.shape[1] * q.shape[3] * pairs,
                           torch.bfloat16)
    flash = dict(
        name="flash_attention", route="cuda",
        source="gvl_tpu_torch/csrc/flash_attention.cu",
        replaces="gvl_tpu/ops/attention.py:158",
        shape="QA prefill: q [1,10,4096,64] f32, k/v [1,5,4096,64], causal",
        max_abs_err=flash_err,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: attention_reference(q, k, v, causal=True), 5),
        bound_ms=flash_bound[0], bound_by=flash_bound[1], bound_peak=flash_bound[2],
        library_ms=time_ms(lambda: library_flash(q, k, v, True)),
    )
    # the bf16 SigLIP so400m tower's attention (8 frames, head_dim 72, padded
    # to 80 by the wrapper) and its MAP head (one probe row over 729 keys)
    flash["lines"] = []
    for shape, seq_q in (("so400m tower: q/k/v [8,16,729,72] bf16", 729),
                         ("so400m MAP head: q [8,16,1,72], k/v [8,16,729,72] bf16", 1)):
        qt = randn(8, 16, seq_q, 72, dtype=torch.bfloat16)
        kt, vt = (randn(8, 16, 729, 72, dtype=torch.bfloat16) for _ in range(2))
        err = assert_close(f"flash_attention {shape}", flash_attention(qt, kt, vt),
                           attention_reference(qt, kt, vt), BF16_TOL)
        line_bound = bound_ms(sum(t.nbytes for t in (qt, kt, vt)) + qt.nbytes,
                              4.0 * 8 * 16 * 72 * seq_q * 729, torch.bfloat16)
        flash["lines"].append(dict(
            name="flash_attention", shape=shape, max_abs_err=err,
            ms=time_ms(lambda: flash_attention(qt, kt, vt), 50),
            plain_ms=time_ms(lambda: attention_reference(qt, kt, vt), 10),
            bound_ms=line_bound[0], bound_by=line_bound[1], bound_peak=line_bound[2],
            library="SDPA, bf16",
            library_ms=time_ms(lambda: library_flash(qt, kt, vt, False), 50)))

    # the perception encoders' attention, f32 as those models run (PERF.md
    # rows 1c-1f): the segmenter's image encoder (32 frames), its mask
    # decoder's cross-attention (32 frames x 4 concepts, head 32 padded to
    # 64 by the wrapper), the byte ASR's encoder and its cached decode's
    # cross-attention (4 windows, one query row per step)
    for shape, b, h, sq, sk, d in (
            ("segmenter image encoder: q/k/v [32,6,256,64] f32", 32, 6, 256, 256, 64),
            ("segmenter mask decoder cross-attention: q [128,8,8,32], k/v [128,8,257,32] "
             "f32 (head padded to 64)", 128, 8, 8, 257, 32),
            ("byte ASR encoder: q/k/v [4,4,300,64] f32", 4, 4, 300, 300, 64),
            ("byte ASR decode cross-attention: q [4,4,1,64], k/v [4,4,300,64] f32",
             4, 4, 1, 300, 64)):
        qt = randn(b, h, sq, d)
        kt, vt = randn(b, h, sk, d), randn(b, h, sk, d)
        err = assert_close(f"flash_attention {shape}", flash_attention(qt, kt, vt),
                           attention_reference(qt, kt, vt), F32_TOL)
        line_bound = bound_ms(sum(t.nbytes for t in (qt, kt, vt)) + qt.nbytes,
                              4.0 * b * h * d * sq * sk, torch.bfloat16)
        flash["lines"].append(dict(
            name="flash_attention", shape=shape, max_abs_err=err,
            ms=time_ms(lambda: flash_attention(qt, kt, vt), 50),
            plain_ms=time_ms(lambda: attention_reference(qt, kt, vt), 10),
            bound_ms=line_bound[0], bound_by=line_bound[1], bound_peak=line_bound[2],
            library="SDPA, f32",
            library_ms=time_ms(lambda: library_flash(qt, kt, vt, False), 50)))

    live = 3072   # a usual QA prompt: the decode reads ~3K of the 4608 rows
    q = randn(1, 10, 64)
    kc = randn(1, 5, 4608, 64, dtype=torch.bfloat16)
    vc = randn(1, 5, 4608, 64, dtype=torch.bfloat16)
    lengths = torch.tensor([live], dtype=torch.int32, device=dev)
    want = decode_attention_reference(q, kc, vc, lengths)
    dec_err = assert_close(f"decode_attention QA timed lengths {lengths.tolist()}",
                           decode_attention(q, kc, vc, lengths), want, decode_tol(want))
    q4 = q.to(torch.bfloat16)[:, :, None, :]
    k_live, v_live = kc[:, :, :live], vc[:, :, :live]
    dec_bound = bound_ms(2 * 5 * live * 64 * 2 + 2 * q.nbytes + 4,
                         4.0 * 10 * 64 * live, q.dtype)
    decode = dict(
        name="decode_attention", route="cuda",
        source="gvl_tpu_torch/csrc/decode_attention.cu",
        replaces="gvl_tpu/ops/decode_attention.py:80",
        shape="QA decode: q [1,10,64] f32, bf16 cache [1,5,4608,64], length 3072",
        max_abs_err=dec_err,
        ms=time_ms(lambda: decode_attention(q, kc, vc, lengths), 100),
        plain_ms=time_ms(lambda: decode_attention_reference(q, kc, vc, lengths), 100),
        bound_ms=dec_bound[0], bound_by=dec_bound[1], bound_peak=dec_bound[2],
        library_ms=time_ms(lambda: library_decode(q4, k_live, v_live), 100),
    )

    cache = randn(1, 8, 1024, 128, dtype=torch.bfloat16)
    new = randn(1, 8, 128, dtype=torch.bfloat16)
    pos = torch.tensor([517], dtype=torch.int32, device=dev)
    pos_long = pos.long()
    new3 = new[:, :, None, :]
    app_bound = bound_ms(2 * new.nbytes + pos.nbytes, 0.0, new.dtype)
    append = dict(
        name="cache_append", route="cuda",
        source="gvl_tpu_torch/csrc/cache_append.cu",
        replaces="gvl_tpu/ops/cache_update.py:42",
        shape="8B decode: cache [1,8,1024,128] bf16, one row",
        max_abs_err=checked_append("cache_append 8B B1 position 517",
                                   lambda: cache_append(cache, new, pos),
                                   lambda: cache_append_reference(cache, new, pos), [cache]),
        ms=time_ms(lambda: cache_append(cache, new, pos), 100),
        plain_ms=time_ms(lambda: cache_append_reference(cache, new, pos), 100),
        bound_ms=app_bound[0], bound_by=app_bound[1], bound_peak=app_bound[2],
        library_ms=time_ms(lambda: cache.index_copy_(2, pos_long, new3), 100),
    )
    # the pair forms at the served decode writes, each against the same two
    # writes by other means
    cache_v = randn(1, 8, 1024, 128, dtype=torch.bfloat16)
    new_v = randn(1, 8, 128, dtype=torch.bfloat16)
    new3_v = new_v[:, :, None, :]
    pair_8b = pair_line(
        "cache_append_kv", "8B decode: K and V caches [1,8,1024,128] bf16, one row each",
        lambda: cache_append_kv(cache, cache_v, new, new_v, pos),
        lambda: cache_append_kv_reference(cache, cache_v, new, new_v, pos),
        lambda: (cache.index_copy_(2, pos_long, new3),
                 cache_v.index_copy_(2, pos_long, new3_v)),
        "2 x index_copy_", 2 * (2 * new.nbytes) + pos.nbytes, new.dtype, [cache, cache_v])
    qa_k, qa_v = (randn(1, 5, 4608, 64, dtype=torch.bfloat16) for _ in range(2))
    qa_rk, qa_rv = randn(1, 5, 64), randn(1, 5, 64)
    qa_pos = torch.tensor([3071], dtype=torch.int32, device=dev)

    def qa_scatter():
        """What the QA model's decode write was before the kernel took it."""
        slot = torch.arange(1, device=dev)
        p = qa_pos.long()
        qa_k[slot, :, p, :] = qa_rk.to(torch.bfloat16)
        qa_v[slot, :, p, :] = qa_rv.to(torch.bfloat16)

    pair_qa = pair_line(
        "cache_append_kv", "QA decode: f32 rows [1,5,64] into bf16 K and V caches "
        "[1,5,4608,64], cast in the kernel",
        lambda: cache_append_kv(qa_k, qa_v, qa_rk, qa_rv, qa_pos),
        lambda: cache_append_kv_reference(qa_k, qa_v, qa_rk, qa_rv, qa_pos),
        qa_scatter, "the scatter block it replaces (arange, .long(), 2 x cast + index_put_)",
        2 * (qa_rk.nbytes + qa_rk.nbytes // 2) + qa_pos.nbytes, torch.float32, [qa_k, qa_v])
    append["pairs"] = [pair_8b, pair_qa]
    # chunk_attention at a QA admission (a 2048-token bucket at offset 0)
    q, kc, vc, start = chunk_in
    seq, live = q.shape[2], int(start[0]) + q.shape[2]
    pairs = sum(int(start[0]) + r + 1 for r in range(seq))
    # the kernel runs q k^T and P V on bf16 tensor cores (the f32 query split
    # into bf16 hi + lo): the bound is taken at their peak
    chunk_bound = bound_ms(2 * q.nbytes + 2 * kc[:, :, :live].nbytes + start.nbytes,
                           4.0 * q.shape[1] * q.shape[3] * pairs, torch.bfloat16)
    q16 = q.to(torch.bfloat16)
    k_live, v_live = kc[:, :, :live].contiguous(), vc[:, :, :live].contiguous()
    chunk_mask = (torch.arange(live, device=dev)[None, :]
                  <= int(start[0]) + torch.arange(seq, device=dev)[:, None])
    chunk = dict(
        name="chunk_attention", route="cuda",
        source="gvl_tpu_torch/csrc/chunk_attention.cu",
        replaces="gvl_tpu/ops/decode_attention.py:388",
        shape="QA admission: q [1,10,2048,64] f32 at start 0, bf16 cache [1,5,4608,64]",
        max_abs_err=chunk_err,
        ms=time_ms(lambda: chunk_attention(q, kc, vc, start)),
        plain_ms=time_ms(lambda: chunk_attention_reference(q, kc, vc, start), 5),
        bound_ms=chunk_bound[0], bound_by=chunk_bound[1], bound_peak=chunk_bound[2],
        library_ms=time_ms(lambda: library_masked(q16, k_live, v_live, chunk_mask)),
    )

    # the stacked forms at the 8B scan-layers decode: 4 slots just past
    # their 128-token prompts, layer 2 of 4
    lengths = torch.tensor([129, 134, 140, 144], dtype=torch.int32, device=dev)
    live_rows = int(lengths.sum())
    q = randn(4, 32, 128, dtype=torch.bfloat16)
    q4 = q[:, :, None, :]
    want = decode_attention_stacked_reference(q, k_all, v_all, lengths, 2)
    st_bound = bound_ms(2 * live_rows * 8 * 128 * 2 + 2 * q.nbytes + lengths.nbytes,
                        4.0 * 32 * 128 * live_rows, q.dtype)
    st_mask = (torch.arange(1024, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    stacked = dict(
        name="decode_attention_stacked", route="cuda",
        source="gvl_tpu_torch/csrc/decode_attention.cu",
        replaces="gvl_tpu/ops/decode_attention.py:198",
        shape="8B scan decode: q [4,32,128] bf16, layer 2 of [4,4,8,1024,128], "
              "lengths 129-144",
        max_abs_err=max(stacked_err, assert_close(
            f"decode_attention_stacked 8B timed lengths {lengths.tolist()} layer 2",
            decode_attention_stacked(q, k_all, v_all, lengths, 2), want, decode_tol(want))),
        ms=time_ms(lambda: decode_attention_stacked(q, k_all, v_all, lengths, 2), 100),
        plain_ms=time_ms(lambda: decode_attention_stacked_reference(
            q, k_all, v_all, lengths, 2), 100),
        bound_ms=st_bound[0], bound_by=st_bound[1], bound_peak=st_bound[2],
        library_ms=time_ms(lambda: library_masked(q4, k_all[2], v_all[2], st_mask), 100),
    )

    pos = lengths - 1
    new = randn(4, 8, 128, dtype=torch.bfloat16)
    layer_rows = k_all[2].view(-1, 128)
    flat_rows = ((torch.arange(4, device=dev)[:, None] * 8
                  + torch.arange(8, device=dev)[None, :]) * 1024 + pos[:, None].long()).reshape(-1)
    new_rows = new.reshape(-1, 128)
    ap_bound = bound_ms(2 * new.nbytes + pos.nbytes, 0.0, new.dtype)
    append_stacked = dict(
        name="cache_append_stacked", route="cuda",
        source="gvl_tpu_torch/csrc/cache_append.cu",
        replaces="gvl_tpu/ops/cache_update.py:113",
        shape="8B scan decode: one row per slot into layer 2 of [4,4,8,1024,128] bf16",
        max_abs_err=checked_append(
            f"cache_append_stacked 8B scan positions {pos.tolist()} layer 2",
            lambda: cache_append_stacked(k_all, new, pos, 2),
            lambda: cache_append_stacked_reference(k_all, new, pos, 2), [k_all]),
        ms=time_ms(lambda: cache_append_stacked(k_all, new, pos, 2), 100),
        plain_ms=time_ms(lambda: cache_append_stacked_reference(k_all, new, pos, 2), 20),
        bound_ms=ap_bound[0], bound_by=ap_bound[1], bound_peak=ap_bound[2],
        library_ms=time_ms(lambda: layer_rows.index_copy_(0, flat_rows, new_rows), 100),
    )
    new_v = randn(4, 8, 128, dtype=torch.bfloat16)
    layer_rows_v, new_rows_v = v_all[2].view(-1, 128), new_v.reshape(-1, 128)
    append_stacked["pairs"] = [pair_line(
        "cache_append_stacked_kv", "8B scan decode: one row per slot into layer 2 of the "
        "K and V caches [4,4,8,1024,128] bf16",
        lambda: cache_append_stacked_kv(k_all, v_all, new, new_v, pos, 2),
        lambda: cache_append_stacked_kv_reference(k_all, v_all, new, new_v, pos, 2),
        lambda: (layer_rows.index_copy_(0, flat_rows, new_rows),
                 layer_rows_v.index_copy_(0, flat_rows, new_rows_v)),
        "2 x index_copy_", 2 * (2 * new.nbytes) + pos.nbytes, new.dtype, [k_all, v_all])]
    rows = [flash, decode, append, chunk, stacked, append_stacked]
    for row in rows:
        log("kernels", f"{row['name']} at {row['shape']}: kernel {row['ms']:.4f} ms,"
            f" plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms,"
            f" bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
        for pair in (*row.get("pairs", ()), *row.get("lines", ())):
            log("kernels", f"  {pair['name']} at {pair['shape']}: kernel "
                f"{pair['ms']:.4f} ms, plain {pair['plain_ms']:.4f} ms, "
                f"{pair['library']} {pair['library_ms']:.4f} ms, bound "
                f"{pair['bound_ms']:.7f} ms ({pair['bound_by']})")
    return rows


def hard_rows(x):
    """x with bf16 rounding ties (low 16 bits 0x8000, the kept bit odd and
    even) and one ulp either side of them in every row, and NaN, -NaN,
    +-inf and the largest f32 (rounds up to inf) in its first columns."""
    import torch

    bits = x.view(torch.int32).clone()
    low = torch.tensor([0x8000, 0x7FFF, 0x8001, 0x18000], dtype=torch.int32,
                       device=x.device)
    bits[..., 8:24] = (bits[..., 8:24] & ~0x1FFFF) | low.repeat(4)
    special = torch.tensor([0x7FC00000, -0x3FFFFF, 0x7F800000, -0x800000,
                            0x7F7FFFFF], dtype=torch.int32, device=x.device)
    bits[..., :5] = special
    return bits.view(torch.float32)


def checked_append(what: str, kernel, plain, caches) -> float:
    """Run an append's plain version (copies) and then its kernel on the
    same tensors; the kernel must return ``caches`` themselves, written in
    place, bit for bit the plain version's (NaN equal to itself).  Returns
    the largest absolute difference, 0 where the bits agree."""
    import torch

    want = plain()
    ptrs = [c.data_ptr() for c in caches]
    got = kernel()
    torch.cuda.synchronize()
    got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
    same = all(g is c and c.data_ptr() == p for g, c, p in zip(got, caches, ptrs))
    errs, equal = [], True
    for g, w in zip(got, want):
        bits = {2: torch.int16, 4: torch.int32}[g.element_size()]
        agree = g.view(bits) == w.view(bits)
        equal = equal and bool(agree.all())
        errs.append((g.float() - w.float()).abs().masked_fill(agree, 0.0).max())
    err = torch.stack(errs).max().item()    # NaN where a NaN was not kept
    ok = same and equal
    log("kernels", f"{what}: same data_ptr {same}, bit-equal to the plain version (all"
        f" other rows untouched) {equal}, max abs err {err:.3g}: {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return err


def pair_line(name, shape, kernel, plain, library, library_name, nbytes, dtype,
              caches) -> dict:
    """One pair form held against its plain version on the tensors it is
    timed on, then its time, its plain version's and that of the same two
    writes made by other means; the bound is its bytes (rows read, rows
    written, positions) over the card's memory rate."""
    err = checked_append(f"{name} at {shape}", kernel, plain, caches)
    bound = bound_ms(nbytes, 0.0, dtype)
    return dict(name=name, shape=shape, max_abs_err=err, ms=time_ms(kernel, 100),
                plain_ms=time_ms(plain, 20), library=library_name,
                library_ms=time_ms(library, 100), bound_ms=bound[0], bound_by=bound[1])


def library_int_mm(x, w, scale, bias, epilogue, out_inv=None, residual=None):
    """Yardstick only: PyTorch's int8 product (cuBLASLt) and the epilogue in
    torch."""
    import torch

    y = torch._int_mm(x, w.t()).float() * scale + bias
    if epilogue == "gelu_quant":
        y = torch.clamp(torch.round(
            torch.nn.functional.gelu(y, approximate="tanh") * out_inv), -127, 127)
        return y.to(torch.int8)
    if epilogue == "residual":
        y = y + residual.float()
    return y.to(torch.bfloat16)


def library_layer_norm_quant(x, g, b, inv):
    """Yardstick only: PyTorch's LayerNorm, then the quantize in torch."""
    import torch
    import torch.nn.functional as F

    y = F.layer_norm(x.float(), x.shape[-1:], g, b, 1e-6)
    return torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8)


def library_quant(x, inv):
    """Yardstick only: the static quantize in torch."""
    import torch

    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


def library_encoder_attention(qkv, batch, seq_pad, heads, dh, mask):
    """Yardstick only: PyTorch's fused attention on the q/k/v heads of the
    packed projection (strided views), keys masked past kv_len."""
    import torch.nn.functional as F

    q, k, v = qkv.view(batch, seq_pad, 3, heads, dh).permute(2, 0, 3, 1, 4)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def check_quant_kernels(dev) -> list[dict]:
    """B7-B12 against their plain versions at the so400m tower's shapes (a
    batch of 8 frames at the 384 canvas: M 5888, Sp 736, kv_len 729; the
    region bucket of 16 at the 128 canvas: M 1536, Sp 96, kv_len 81)."""
    import torch

    from gvl_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def int8_close(what, got, want) -> float:
        diff = (got.int() - want.int()).abs()
        share = (diff > 0).float().mean().item()
        ok = diff.max().item() <= 1 and share <= INT8_FLIP_SHARE
        log("kernels", f"{what}: int8 max diff {diff.max().item()}, share differing "
            f"{share:.2e} (limit 1 step on {INT8_FLIP_SHARE:.0e}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{what}: kernel disagrees with its plain version")
        return float(diff.max().item())

    rows, errs, mm_in = [], {}, {}
    # B7: the four products of a layer and the regions' qkv; y spreads about
    # +-3 (+-60 for quant)
    m = 5888
    cases = [("qkv", 1152, 6144, "none"), ("o", 2048, 1152, "residual"),
             ("fc1", 1152, 4352, "gelu_quant"), ("fc2", 4352, 1152, "residual"),
             ("regions qkv", 1152, 6144, "none")]
    for name, k, n, epilogue in cases:
        mi = 1536 if name.startswith("regions") else m
        x, w = int8(mi, k), int8(n, k)
        scale = (randn(n).abs() + 0.5) * (3.0 / (5376 * k ** 0.5))
        bias = randn(n) * 0.1
        res = randn(mi, n, dtype=torch.bfloat16)
        kw = dict(epilogue=epilogue, out_scale_inv=37.5 if epilogue == "gelu_quant" else None,
                  residual=res if epilogue == "residual" else None)
        got = qm.w8a8_matmul(x, w, scale, bias, **kw)
        want = qm.w8a8_matmul_reference(x, w, scale, bias, **kw)
        torch.cuda.synchronize()
        what = (f"w8a8_matmul {name} [{mi},{k}]x[{n},{k}] {epilogue} "
                f"(tile 128x{qm.w8a8_block_n(n)})")
        if epilogue == "gelu_quant":
            errs[name] = int8_close(what, got, want)
        else:
            errs[name] = assert_close(what, got, want, BF16_TOL)
        mm_in[name] = (what, x, w, scale, bias, kw)
    mm_lines = []
    for name in mm_in:
        what, x, w, scale, bias, kw = mm_in[name]
        mi, k = x.shape
        n = w.shape[0]
        out_bytes = mi * n * (1 if kw["epilogue"] == "gelu_quant" else 2)
        res_bytes = 0 if kw["residual"] is None else kw["residual"].nbytes
        bnd = bound_ms(x.nbytes + w.nbytes + 8 * n + out_bytes + res_bytes,
                       2.0 * mi * k * n, torch.int8)
        mm_lines.append(dict(
            name="w8a8_matmul", shape=what[len("w8a8_matmul "):], max_abs_err=errs[name],
            ms=time_ms(lambda: qm.w8a8_matmul(x, w, scale, bias, **kw)),
            plain_ms=time_ms(lambda: qm.w8a8_matmul_reference(x, w, scale, bias, **kw), 5),
            bound_ms=bnd[0], bound_by=bnd[1], bound_peak=bnd[2],
            library="torch._int_mm + epilogue",
            library_ms=time_ms(lambda: library_int_mm(
                x, w, scale, bias, kw["epilogue"], kw["out_scale_inv"], kw["residual"]))))
    qkv = mm_lines[0]
    rows.append(dict(
        qkv, route="cuda", source="gvl_tpu_torch/csrc/w8a8_matmul.cu",
        replaces="gvl_tpu/ops/quant_matmul.py:135",
        shape="so400m qkv, batch 8: int8 [5888,1152] x [6144,1152], bf16 out",
        max_abs_err=max(errs.values()), lines=mm_lines[1:]))
    check_wgmma_sass()

    # B8 and B11: the residual stream of a batch of 8 (and of the regions)
    for mi in (5888, 1536):
        xs = randn(mi, 1152, dtype=torch.bfloat16) * 2.0
        g, b = randn(1152).abs() + 0.5, randn(1152) * 0.1
        errs_ln = int8_close(f"ln_quant [{mi},1152] bf16", qm.ln_quant(xs, g, b, 40.0),
                             qm.ln_quant_reference(xs, g, b, 40.0))
        errs_q = int8_close(f"quant_static [{mi},1152] bf16", qm.quant_static(xs, 20.0),
                            qm.quant_static_reference(xs, 20.0))
        if mi == 5888:
            x_ln, ln_err, q_err = (xs, g, b), errs_ln, errs_q
    xs, g, b = x_ln
    ln_bound = bound_ms(xs.nbytes + 8 * 1152 + xs.numel(), 9.0 * xs.numel(), torch.float32)
    rows.append(dict(
        name="ln_quant", route="cuda", source="gvl_tpu_torch/csrc/ln_quant.cu",
        replaces="gvl_tpu/ops/quant_matmul.py:694",
        shape="so400m residual stream, batch 8: bf16 [5888,1152] -> int8",
        max_abs_err=ln_err, ms=time_ms(lambda: qm.ln_quant(xs, g, b, 40.0), 100),
        plain_ms=time_ms(lambda: qm.ln_quant_reference(xs, g, b, 40.0), 20),
        bound_ms=ln_bound[0], bound_by=ln_bound[1], bound_peak=ln_bound[2],
        library_ms=time_ms(lambda: library_layer_norm_quant(xs, g, b, 40.0), 100)))
    q_bound = bound_ms(xs.nbytes + xs.numel(), 3.0 * xs.numel(), torch.float32)
    rows.append(dict(
        name="quant_static", route="cuda", source="gvl_tpu_torch/csrc/ln_quant.cu",
        replaces="gvl_tpu/ops/quant_matmul.py:745",
        shape="bf16 [5888,1152] -> int8 (on no served path)",
        max_abs_err=q_err, ms=time_ms(lambda: qm.quant_static(xs, 20.0), 100),
        plain_ms=time_ms(lambda: qm.quant_static_reference(xs, 20.0), 20),
        bound_ms=q_bound[0], bound_by=q_bound[1], bound_peak=q_bound[2],
        library_ms=time_ms(lambda: library_quant(xs, 20.0), 100)))

    # B9, B10, B12: the attention of a layer, frames and regions
    att = {}
    for label, batch, sp, kv_len in (("frames", 8, 736, 729), ("regions", 16, 96, 81)):
        qkv = randn(batch * sp, 3 * 16 * 128, dtype=torch.bfloat16)
        qkv.view(batch * sp, 48, 128)[..., 72:] = 0      # heads padded as served
        packed = randn(batch * sp, 3 * 16 * 72, dtype=torch.bfloat16)
        kw = dict(batch=batch, seq_pad=sp, kv_len=kv_len, num_heads=16,
                  sm_scale=1.0 / math.sqrt(72.0))
        for int8_scores in (False, True):
            what = f"attention_fused_qkv {label} [{batch * sp},6144] int8_scores={int8_scores}"
            e = int8_close(what, qm.attention_fused_qkv(
                qkv, dh_pad=128, int8_scores=int8_scores, out_scale_inv=40.0, **kw),
                qm.attention_fused_qkv_reference(
                    qkv, dh_pad=128, int8_scores=int8_scores, out_scale_inv=40.0, **kw))
            att[("fused", label)] = max(att.get(("fused", label), 0.0), e)
        att[("packed", label)] = int8_close(
            f"attention_packed_multihead {label} [{batch * sp},3456]",
            qm.attention_packed_multihead(packed, head_dim=72, out_scale_inv=40.0, **kw),
            qm.attention_packed_multihead_reference(packed, head_dim=72,
                                                    out_scale_inv=40.0, **kw))
        att[("qkv_packed", label)] = assert_close(
            f"attention_qkv_packed {label} [{batch * sp},3456]",
            qm.attention_qkv_packed(packed, head_dim=72, **kw),
            qm.attention_qkv_packed_reference(packed, head_dim=72, **kw), BF16_TOL)
        if label == "frames":
            frames = (qkv, packed, kw)
    qkv, packed, kw = frames
    # keys past kv_len are never read: NaN in the k and v columns of the
    # padded rows (729 .. 735 of every frame) changes no output bit
    for name, buf, extra in (
            ("attention_fused_qkv", qkv, dict(dh_pad=128, out_scale_inv=40.0)),
            ("attention_packed_multihead", packed, dict(head_dim=72, out_scale_inv=40.0)),
            ("attention_qkv_packed", packed, dict(head_dim=72))):
        fn = getattr(qm, name)
        clean = fn(buf, **kw, **extra)
        poisoned = buf.clone()
        poisoned.view(8, 736, 3, -1)[:, 729:, 1:] = float("nan")
        same = torch.equal(fn(poisoned, **kw, **extra), clean)
        log("kernels", f"{name} frames, NaN in k and v past kv_len 729: output "
            f"{'bit-identical: ok' if same else 'CHANGED'}")
        if not same:
            raise AssertionError(f"{name}: keys past kv_len reach the output")
    pairs = 8 * 16 * 736 * 729
    mask = (torch.arange(736, device=dev) < 729)[None, None, None, :]
    for name, key, buf, dh, line, extra, shape in (
            ("attention_fused_qkv", "fused", qkv, 128, 596,
             dict(dh_pad=128, out_scale_inv=40.0),
             "so400m layer, batch 8: bf16 [5888,3x16x128] (heads padded) -> int8"),
            ("attention_packed_multihead", "packed", packed, 72, 437,
             dict(head_dim=72, out_scale_inv=40.0),
             "so400m layer, batch 8: bf16 [5888,3x16x72] -> int8 (packed variant)"),
            ("attention_qkv_packed", "qkv_packed", packed, 72, 354, dict(head_dim=72),
             "bf16 [5888,3x16x72] -> bf16, exp (on no served path)")):
        fn = getattr(qm, name)
        plain = getattr(qm, name + "_reference")
        out_bytes = buf.nbytes // 3 // (1 if name == "attention_qkv_packed" else 2)
        bnd = bound_ms(buf.nbytes + out_bytes, 4.0 * dh * pairs, torch.bfloat16)
        rows.append(dict(
            name=name, route="cuda", source="gvl_tpu_torch/csrc/encoder_attention.cu",
            replaces=f"gvl_tpu/ops/quant_matmul.py:{line}", shape=shape,
            max_abs_err=max(att[(key, "frames")], att[(key, "regions")]),
            ms=time_ms(lambda: fn(buf, **kw, **extra)),
            plain_ms=time_ms(lambda: plain(buf, **kw, **extra), 5),
            bound_ms=bnd[0], bound_by=bnd[1], bound_peak=bnd[2],
            library_ms=time_ms(lambda: library_encoder_attention(buf, 8, 736, 16, dh, mask))))
    for row in rows:
        log("kernels", f"{row['name']} at {row['shape']}: kernel {row['ms']:.4f} ms,"
            f" plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms,"
            f" bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
        for line in row.get("lines", ()):
            log("kernels", f"  {line['name']} at {line['shape']}: kernel "
                f"{line['ms']:.4f} ms, plain {line['plain_ms']:.4f} ms, "
                f"{line['library']} {line['library_ms']:.4f} ms, bound "
                f"{line['bound_ms']:.5f} ms ({line['bound_by']})")
    return rows


def check_wgmma_sass() -> None:
    """The built library's w8a8_matmul kernels issue warpgroup int8
    products (IGMMA in the SASS) and no mma.sync ones (IMMA), read with
    cuobjdump where the toolkit has it."""
    from gvl_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        log("kernels", f"SASS of w8a8_matmul not checked: no {tool}")
        return
    sass = subprocess.run([str(tool), "--dump-sass", str(_build.build().path)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    kernels = [part for part in sass.split("Function : ")[1:]
               if "w8a8_matmul_kernel" in part.split("\n", 1)[0]]
    igmma = [part.count("IGMMA") for part in kernels]
    imma = sum(len(re.findall(r"\bIMMA\b", part)) for part in kernels)
    log("kernels", f"SASS: {len(kernels)} w8a8_matmul kernels, IGMMA per kernel "
        f"{sorted(set(igmma))}, IMMA {imma}")
    if not kernels or min(igmma) == 0 or imma:
        raise AssertionError("w8a8_matmul: the built kernels are not on wgmma")


# --------------------------------------------------------------------------
# phases 3 and 4: the served models
# --------------------------------------------------------------------------

class TimedEngine:
    """Engine proxy that times prefill (to the first token) and decode."""

    def __init__(self, engine):
        self.engine = engine
        self.config = engine.config
        self.prefill_s = self.decode_s = 0.0
        self.prompts = self.decode_steps = 0
        self.prompt_ids: list[list[int]] = []

    def generate(self, prompt_ids, **kw) -> list[int]:
        import torch

        self.prompt_ids.append(list(prompt_ids))
        out = []
        start = time.perf_counter()
        first = None
        for token in self.engine.stream(prompt_ids, **kw):
            if first is None:
                first = time.perf_counter()   # prefill done: the token is on the host
            out.append(token)
        torch.cuda.synchronize()
        end = time.perf_counter()
        first = end if first is None else first
        self.prompts += 1
        self.prefill_s += first - start
        self.decode_s += end - first
        self.decode_steps += len(out)   # one decode step follows each token
        return out

    def summary(self) -> str:
        rate = self.decode_steps / self.decode_s if self.decode_s else float("nan")
        return (f"prefill {1e3 * self.prefill_s / max(self.prompts, 1):.1f} ms/prompt,"
                f" decode {rate:.1f} tokens/s ({self.decode_steps} steps)")


def kernel_wrappers() -> tuple:
    from gvl_tpu_torch.ops import attention, cache_update, decode_attention, quant_matmul

    return (attention.flash_attention, decode_attention.decode_attention,
            cache_update.cache_append, decode_attention.chunk_attention,
            decode_attention.decode_attention_stacked,
            cache_update.cache_append_stacked, quant_matmul.w8a8_matmul,
            quant_matmul.ln_quant, quant_matmul.attention_fused_qkv,
            quant_matmul.attention_packed_multihead, quant_matmul.quant_static,
            quant_matmul.attention_qkv_packed)


# kernels that lie on no served path, as in the JAX package (phase 2 only)
UNSERVED = ("quant_static", "attention_qkv_packed")


def kernel_launches() -> dict[str, int]:
    return {f.__name__: f.launches for f in kernel_wrappers()}


def reset_launches() -> None:
    for f in kernel_wrappers():
        f.launches = 0


# each decode step writes a layer's K and V rows with one append launch and
# reads them with one decode-attention launch
APPEND_PER_DECODE = (("cache_append", "decode_attention"),
                     ("cache_append_stacked", "decode_attention_stacked"))


def served_launches(phase: str, expected: tuple[str, ...]) -> dict[str, int]:
    """The counts since the last reset; fails unless every kernel of the
    served path was launched, and unless the appends equal the decode
    attentions (one pair launch per layer and step)."""
    launches = kernel_launches()
    missing = [name for name in expected if launches[name] == 0]
    log(phase, f"launches {launches}")
    if missing:
        raise AssertionError(f"{phase}: kernels of this path not launched: {missing}")
    for append, decode in APPEND_PER_DECODE:
        if launches[append] != launches[decode]:
            raise AssertionError(
                f"{phase}: {launches[append]} {append} launches for {launches[decode]} "
                f"{decode}: a decode step must write K and V in one launch per layer")
    return launches


@contextlib.contextmanager
def uncounted():
    """Launches inside are a reference run to compare with, not served work:
    the counts are restored after it."""
    saved = kernel_launches()
    try:
        yield
    finally:
        for f in kernel_wrappers():
            f.launches = saved[f.__name__]


class Replay:
    """Engine stand-in that hands back answers computed elsewhere, so that
    ``evaluate_qa_lm`` scores a batch that was served in one go."""

    def __init__(self, outputs):
        self.outputs = iter(outputs)

    def generate(self, prompt_ids, **kw) -> list[int]:
        return next(self.outputs)


def run_qa(dev):
    import torch

    from gvl_tpu_torch.agent.config import GenerationConfig
    from gvl_tpu_torch.agent.core import create_qa_backend
    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine
    from gvl_tpu_torch.training.qa_lm_train import evaluate_qa_lm

    reference = json.loads((QA_CKPT / "metrics.json").read_text())
    want = reference["heldout_by_seed"][str(QA_SEED)]
    backend = create_qa_backend(QA_CKPT, device=dev)
    engine = backend.engine
    log("qa", f"loaded {QA_CKPT.relative_to(REPO)}: {engine.config.num_layers} layers,"
        f" hidden {engine.config.hidden_size}, cache {engine.config.max_cache_length}")

    timed = TimedEngine(engine)
    reset_launches()
    got = evaluate_qa_lm(n_samples=QA_SAMPLES, seed=QA_SEED, engine=timed)
    launches = served_launches("qa", ("flash_attention", "decode_attention",
                                      "cache_append"))
    log("qa", f"kernel path: accuracy {got['accuracy']:.3f} (metrics.json {want}),"
        f" by_family {json.dumps(got['by_family'], sort_keys=True)}")
    log("qa", f"kernel path: {timed.summary()}; launches {launches}, "
        f"{sum(launches.values()) / max(timed.decode_steps + timed.prompts, 1):.1f}"
        " per generated token")
    with uncounted():
        # every CUDA launch of a decode step (the port's kernels, cuBLAS and
        # PyTorch's own), counted by the profiler on one held-out prompt
        from gvl_tpu_torch.device_times import decode_profile

        eos, engine.eos_token_id = engine.eos_token_id, -1
        try:
            step = decode_profile(engine, timed.prompt_ids[0], 16)
        finally:
            engine.eos_token_id = eos
    log("qa", f"decode step, {len(timed.prompt_ids[0])}-token prompt: "
        f"{step['device_launches_per_step']:.1f} CUDA launches and "
        f"{step['device_copies_per_step']:.1f} copies per step, wall "
        f"{step['wall_ms_per_step']:.3f} ms, device {step['device_ms_per_step']:.3f} ms "
        f"(busy {step['busy_share']:.1%})")

    plain = Qwen3Engine(engine.config.plain(), engine.model.state_dict(),
                        eos_token_id=EOS_ID, device=dev)
    timed_plain = TimedEngine(plain)
    ref = evaluate_qa_lm(n_samples=QA_SAMPLES, seed=QA_SEED, engine=timed_plain)
    agree = sum(a == b for a, b in zip(got["answers"], ref["answers"]))
    log("qa", f"plain path: accuracy {ref['accuracy']:.3f}, {timed_plain.summary()};"
        f" answers equal to the kernel path: {agree}/{QA_SAMPLES}")

    messages = [
        {"role": "system", "content": "You are a gameplay video analyst. "
                                      "Answer from the timeline."},
        {"role": "user", "content": "## Timeline Context\n[00:12] boss detected\n"
                                    "[00:40] (Audio: impact sound)\n\n## Question\n"
                                    "At what timestamp is the boss first detected? "
                                    "Answer with the [MM:SS] timestamp."},
    ]
    gen_cfg = GenerationConfig(max_new_tokens=48, temperature=0.0)
    text = "".join(backend.stream(messages, gen_cfg))
    plain_text = "".join(type(backend)(plain, backend.tokenizer).stream(messages, gen_cfg))
    log("qa", f"Qwen3ChatBackend.stream: {text!r} (plain path equal: {text == plain_text})")
    torch.cuda.synchronize()

    if not text:
        raise AssertionError("Qwen3ChatBackend.stream produced no text")
    if abs(got["accuracy"] - want) > QA_ACCURACY_SLACK:
        raise AssertionError(f"QA accuracy {got['accuracy']} is not within "
                             f"{QA_ACCURACY_SLACK} of {want}")
    if agree < QA_MIN_AGREE:
        raise AssertionError(f"kernel and plain paths agree on {agree} answers,"
                             f" fewer than {QA_MIN_AGREE}")
    return launches, backend, got["answers"], timed.prompt_ids


def run_8b(dev):
    import torch

    from gvl_tpu_torch.models.qwen3 import KVCache, Qwen3Config, Qwen3Engine, init_params

    # the 8B decoder's layer geometry (as __graft_entry__.entry builds it)
    cfg = Qwen3Config(hidden_size=4096, num_layers=4, num_heads=32, num_kv_heads=8,
                      head_dim=128, intermediate_size=12288, vocab_size=151936,
                      max_cache_length=1024)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    engine = Qwen3Engine(cfg, params, eos_token_id=-1, device=dev)
    plain = Qwen3Engine(cfg.plain(), params, eos_token_id=-1, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128),
                           generator=torch.Generator().manual_seed(0))
    log("8b", f"{cfg.num_layers} layers at hidden {cfg.hidden_size}, "
        f"{sum(p.numel() for p in params.values()) / 1e9:.2f} B bf16 parameters")

    def logits_of(eng, token=None, dtype=torch.bfloat16):
        with torch.inference_mode():
            cache = KVCache.zeros(cfg, 1, dtype=dtype, device=dev)
            pre, cache = eng.model(prompt.to(dev), positions=torch.arange(128, device=dev),
                                   cache=cache)
            token = pre[:, -1].argmax(-1) if token is None else token
            step, _ = eng.model(token[:, None], positions=torch.tensor([128], device=dev),
                                cache=cache)
        return pre.float(), step.float(), token

    pre_k, step_k, token = logits_of(engine)
    pre_p, step_p, _ = logits_of(plain, token)
    # the same weights evaluated in f32 (plain path, f32 cache) as the truth
    truth = Qwen3Engine(cfg.plain(), {k: v.float() for k, v in params.items()},
                        eos_token_id=-1, device=dev)
    pre_t, step_t, _ = logits_of(truth, token, torch.float32)
    del truth
    torch.cuda.empty_cache()

    def rel(x, ref):
        return ((x - ref).norm() / ref.norm()).item()

    for name, got, want, ref in (("prefill", pre_k, pre_p, pre_t),
                                 ("first step", step_k, step_p, step_t)):
        err_k, err_p = rel(got, ref), rel(want, ref)
        ok = err_k <= BF16_ERR_RATIO * err_p and bool(torch.isfinite(got).all())
        log("8b", f"{name} logits {tuple(got.shape)}: relative error against f32,"
            f" kernel path {err_k:.5f}, plain path {err_p:.5f} (limit {BF16_ERR_RATIO}x"
            f" the plain path's); kernel vs plain max abs {max_err(got, want):.4f},"
            f" logits std {ref.std().item():.2f}; {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"8B {name} logits: kernel path strays from f32")

    ids = prompt[0].tolist()
    timed = TimedEngine(engine)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = timed.generate(ids, max_new_tokens=16, temperature=0.0)
    launches = served_launches("8b", ("flash_attention", "decode_attention",
                                      "cache_append"))
    ref = TimedEngine(plain).generate(ids, max_new_tokens=16, temperature=0.0)
    same = sum(a == b for a, b in zip(out, ref))
    log("8b", f"kernel path: {timed.summary()}; launches {launches}; greedy tokens"
        f" equal to the plain path: {same}/{len(out)}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if len(out) != 16:
        raise AssertionError(f"8B engine produced {len(out)} tokens, not 16")
    return launches, cfg, params


# --------------------------------------------------------------------------
# phases 5 to 8: the serving path
# --------------------------------------------------------------------------

def percentile(values: list[float], q: float) -> float:
    values = sorted(values)
    return values[int(q * (len(values) - 1))]


def run_qa_batch(dev, backend, single_answers, prompts):
    """Phase 5: the 40 held-out prompts through one 4-slot batching engine."""
    import torch

    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
    from gvl_tpu_torch.serving import ContinuousBatchingEngine
    from gvl_tpu_torch.training.qa_lm_train import evaluate_qa_lm

    reference = json.loads((QA_CKPT / "metrics.json").read_text())
    want = reference["heldout_by_seed"][str(QA_SEED)]
    cfg = backend.engine.config
    state = backend.engine.model.state_dict()
    engine = ContinuousBatchingEngine(cfg, state, eos_token_id=EOS_ID,
                                      num_slots=QA_SLOTS, device=dev)
    reset_launches()
    start = time.perf_counter()
    ids = [engine.submit(p, QA_MAX_NEW) for p in prompts]
    first: dict[int, float] = {}
    steps = 0
    while engine.has_work:
        engine.step()
        steps += 1
        now = time.perf_counter()
        for rid in ids:
            request = engine._requests[rid]
            if rid not in first and (request.tokens or request.done):
                first[rid] = now - start
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = served_launches("qa-batch", ("chunk_attention", "decode_attention",
                                            "cache_append"))
    outputs = [engine._requests[rid].tokens for rid in ids]
    n_tokens = sum(len(o) for o in outputs)
    got = evaluate_qa_lm(n_samples=QA_SAMPLES, seed=QA_SEED, engine=Replay(outputs))
    agree = sum(a == b for a, b in zip(got["answers"], single_answers))
    ttft = list(first.values())
    log("qa-batch", f"{QA_SLOTS} slots, {len(prompts)} requests: accuracy "
        f"{got['accuracy']:.3f} (metrics.json {want}); answers equal to phase 3's "
        f"Qwen3Engine: {agree}/{QA_SAMPLES}; {n_tokens} tokens in {steps} steps, "
        f"{seconds:.2f} s: {n_tokens / seconds:.1f} tokens/s aggregate; time to first"
        f" token p50 {1e3 * percentile(ttft, 0.5):.0f} ms, p90 "
        f"{1e3 * percentile(ttft, 0.9):.0f} ms (all submitted at once)")
    if abs(got["accuracy"] - want) > QA_ACCURACY_SLACK:
        raise AssertionError(f"batched QA accuracy {got['accuracy']} is not within "
                             f"{QA_ACCURACY_SLACK} of {want}")
    if agree < QA_MIN_AGREE:
        raise AssertionError(f"batched and single-request answers agree on {agree},"
                             f" fewer than {QA_MIN_AGREE}")
    return launches, engine


def http_json(port: int, method: str, path: str, body=None) -> tuple[int, dict]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def follow_up(question: str) -> list[int]:
    """The byte ids of a next user turn in the served ChatML format."""
    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID, ByteTokenizer

    text = f"\n<|im_start|>user\n{question}<|im_end|>\n<|im_start|>assistant\n"
    return [EOS_ID] + ByteTokenizer().encode(text)


def run_http(dev, engine, prompts):
    """Phase 6: EngineServer + create_server on 127.0.0.1, port 0."""
    import threading

    import torch

    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID, ByteTokenizer
    from gvl_tpu_torch.models.session import Qwen3ChatSession
    from gvl_tpu_torch.serving import EngineServer, InferenceService, create_server

    four = prompts[:4]
    expected = engine.generate_many(four, QA_MAX_NEW)
    cfg, state = engine.config, engine.model.state_dict()
    service = InferenceService()
    server = EngineServer(engine)
    service.attach_engine(server, tokenizer=ByteTokenizer(), session_factory=lambda:
                          Qwen3ChatSession(cfg, state, eos_token_id=EOS_ID, device=dev))
    httpd = create_server("127.0.0.1", 0, service=service)
    port = httpd.server_address[1]
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    try:
        reset_launches()
        replies = [None] * 4

        def post(i):
            replies[i] = http_json(port, "POST", "/generate",
                                   {"prompt_ids": four[i], "max_new_tokens": QA_MAX_NEW})

        start = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        seconds = time.perf_counter() - start
        statuses = [r[0] if r else None for r in replies]
        same = sum(r is not None and r[1].get("tokens") == e
                   for r, e in zip(replies, expected))
        log("http", f"4 concurrent POST /generate: status {statuses} in {seconds:.2f}"
            f" s; tokens equal to generate_many: {same}/4")

        turn1 = prompts[4]
        status1, chat1 = http_json(port, "POST", "/chat", {
            "session_id": "smoke", "prompt_ids": turn1, "max_new_tokens": QA_MAX_NEW})
        turn2 = turn1 + chat1["tokens"] + follow_up("Which event came last?")
        delta = len(turn2) - len(turn1) - len(chat1["tokens"])
        status2, chat2 = http_json(port, "POST", "/chat", {
            "session_id": "smoke", "prompt_ids": turn2, "max_new_tokens": QA_MAX_NEW})
        log("http", f"POST /chat turn 1: status {status1}, prefilled {chat1['prefilled']}"
            f" of {len(turn1)}; turn 2: status {status2}, prefilled "
            f"{chat2.get('prefilled')} (delta {delta}), answer {chat2.get('text')!r}")
        status3, metrics = http_json(port, "GET", "/metrics")
        torch.cuda.synchronize()
        launches = served_launches("http", ("chunk_attention", "decode_attention",
                                            "cache_append"))
        log("http", f"GET /metrics: status {status3}, {json.dumps(metrics)}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        serving.join(timeout=30)
    if statuses != [200] * 4 or same != 4:
        raise AssertionError("POST /generate did not return generate_many's tokens")
    if (status1, status2, status3) != (200, 200, 200) or chat2["prefilled"] != delta:
        raise AssertionError("POST /chat turn 2 did not prefill only its delta")
    if server._driver.is_alive() or serving.is_alive():
        raise AssertionError("the serving threads did not stop")
    return launches


def run_session_lookup(dev, backend, prompts):
    """Phase 7: a 3-turn session and prompt lookup against Qwen3Engine."""
    import torch

    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
    from gvl_tpu_torch.models.session import Qwen3ChatSession
    from gvl_tpu_torch.models.speculative import PromptLookupEngine

    engine = backend.engine
    cfg, state = engine.config, engine.model.state_dict()
    reset_launches()
    session = Qwen3ChatSession(cfg, state, eos_token_id=EOS_ID, device=dev)
    lookup = PromptLookupEngine(cfg, state, eos_token_id=EOS_ID, device=dev)
    transcript = prompts[5]
    answer = session.generate(transcript, max_new_tokens=QA_MAX_NEW, temperature=0.0)
    differ = []
    for turn, question in ((2, "Which event came last?"),
                           (3, "What was heard first?")):
        transcript = transcript + answer + follow_up(question)
        answer = session.generate(transcript, max_new_tokens=QA_MAX_NEW,
                                  temperature=0.0)
        with uncounted():
            fresh = engine.generate(transcript, max_new_tokens=QA_MAX_NEW,
                                    temperature=0.0)
        log("session", f"turn {turn}: {len(transcript)} tokens, ingested "
            f"{session.last_ingested}; equal to a fresh Qwen3Engine: {answer == fresh}")
        if answer != fresh:
            differ.append(f"session turn {turn}")
    rounds = accepted = drafted = 0
    start = time.perf_counter()
    n_tokens = 0
    for i, prompt in enumerate(prompts[6:6 + LOOKUP_PROMPTS]):
        out = lookup.generate(prompt, max_new_tokens=QA_MAX_NEW, temperature=0.0)
        n_tokens += len(out)
        stats = lookup.last_stats
        rounds += stats["rounds"]
        accepted += stats["accepted"]
        drafted += stats["drafted"]
        # the speculative engines yield the EOS token that ends a stream
        # (as the JAX package's do); Qwen3Engine stops before it
        if out and out[-1] == EOS_ID:
            out = out[:-1]
        with uncounted():
            fresh = engine.generate(prompt, max_new_tokens=QA_MAX_NEW, temperature=0.0)
        if out != fresh:
            differ.append(f"prompt lookup {i}")
    torch.cuda.synchronize()
    launches = served_launches("session", ("chunk_attention", "decode_attention",
                                           "cache_append"))
    log("session", f"prompt lookup (gamma {lookup.gamma}) on {LOOKUP_PROMPTS} prompts: "
        f"{rounds} verify steps, {accepted} of {drafted} drafted tokens accepted, "
        f"{n_tokens} tokens; streams differing from Qwen3Engine: {differ or 'none'}")
    if len(differ) > STREAM_SLACK:
        raise AssertionError(f"{differ} differ from Qwen3Engine's greedy streams")
    return launches


def run_8b_scan(dev, cfg, params):
    """Phase 8: the 8B geometry with scan_layers through the batching engine."""
    import dataclasses

    import torch

    from gvl_tpu_torch.models.qwen3 import KVCache, load_model, stack_layers
    from gvl_tpu_torch.serving import ContinuousBatchingEngine

    scan_cfg = dataclasses.replace(cfg, scan_layers=True)
    stacked = stack_layers(params, cfg)
    gen = torch.Generator().manual_seed(1)
    lens = [128, 100, 77, 128]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in lens]

    def logits_of(config, weights, dtype=torch.bfloat16):
        """A 4-slot chunk admission at offset 0, then one decode step at the
        slots' own lengths."""
        chunk = load_model(dataclasses.replace(config, chunk_verify=True), weights, dev)
        model = load_model(config, weights, dev)
        tokens = torch.tensor([p + [0] * (128 - len(p)) for p in prompts], device=dev)
        with torch.inference_mode():
            cache = KVCache.zeros(config, 4, dtype=dtype, device=dev)
            pre, _ = chunk(tokens, positions=torch.arange(128, device=dev), cache=cache)
            cache.lengths = lens
            nxt = torch.tensor([[p[-1]] for p in prompts], device=dev)
            step, _ = model(nxt, positions=torch.tensor(lens, device=dev)[:, None],
                            cache=cache)
        live = torch.cat([pre[b, :n] for b, n in enumerate(lens)])
        return live.float(), step.float()

    pre_k, step_k = logits_of(scan_cfg, stacked)
    pre_p, step_p = logits_of(scan_cfg.plain(), stacked)
    truth = {k: v.float() for k, v in stacked.items()}
    pre_t, step_t = logits_of(scan_cfg.plain(), truth, torch.float32)
    del truth
    torch.cuda.empty_cache()

    def rel(x, ref):
        return ((x - ref).norm() / ref.norm()).item()

    for name, got, want, ref in (("admission", pre_k, pre_p, pre_t),
                                 ("decode step", step_k, step_p, step_t)):
        err_k, err_p = rel(got, ref), rel(want, ref)
        ok = err_k <= BF16_ERR_RATIO * err_p and bool(torch.isfinite(got).all())
        log("8b-scan", f"{name} logits {tuple(got.shape)}: relative error against f32,"
            f" kernel path {err_k:.5f}, plain path {err_p:.5f} (limit {BF16_ERR_RATIO}x"
            f" the plain path's); {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"8B scan {name} logits: kernel path strays from f32")

    engine = ContinuousBatchingEngine(scan_cfg, stacked, eos_token_id=-1, num_slots=4,
                                      device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    start = time.perf_counter()
    out = engine.generate_many(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = served_launches("8b-scan", ("chunk_attention", "decode_attention_stacked",
                                           "cache_append_stacked"))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    unrolled = ContinuousBatchingEngine(cfg, params, eos_token_id=-1, num_slots=4,
                                        device=dev).generate_many(prompts, 16)
    same = sum(a == b for x, y in zip(out, unrolled) for a, b in zip(x, y))
    log("8b-scan", f"4 slots x 16 steps in {seconds:.2f} s ({64 / seconds:.1f} tokens/s"
        f" aggregate, admission included); tokens equal to the unrolled kernel path: "
        f"{same}/64; peak memory {peak:.2f} GiB")
    if [len(o) for o in out] != [16] * 4 or same != 64:
        raise AssertionError("8B scan engine tokens differ from the unrolled engine")
    return launches


# --------------------------------------------------------------------------
# phases 9 and 10: the region semantic encoder on the fused SigLIP tower
# --------------------------------------------------------------------------

def cosines(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def check_cosine(phase: str, what: str, got, want, limit: float) -> float:
    import numpy as np

    cos = cosines(got, want)
    ok = bool(np.isfinite(got).all()) and got.shape == want.shape and cos.min() >= limit
    log(phase, f"{what}: pooled cosine min {cos.min():.6f} mean {cos.mean():.6f} "
        f"(limit {limit}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{phase}: {what}: pooled cosine {cos.min()} < {limit}")
    return float(cos.min())


def semantic_inputs():
    """8 seeded 384 x 384 frames; one frame with its masks."""
    import numpy as np

    rng = np.random.default_rng(SEMANTIC_SEED)
    frames = [rng.integers(0, 256, (384, 384, 3), dtype=np.uint8)
              for _ in range(SEMANTIC_FRAMES)]
    return (frames, *region_inputs(rng))


def region_inputs(rng):
    """One 720 x 1280 frame with 16 rectangular masks (30-200 px a side)."""
    import numpy as np

    frame = rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    masks = []
    for i in range(SEMANTIC_MASKS):
        h, w = rng.integers(30, 200, 2)
        y, x = rng.integers(0, 720 - h), rng.integers(0, 1280 - w)
        mask = np.zeros((720, 1280), bool)
        mask[y:y + h, x:x + w] = True
        masks.append((f"entity_{i}", mask))
    return frame, masks


def timed_encode(fn, repeats: int = 3) -> tuple:
    """(result of the last call, seconds per call) on the host clock."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - start) / repeats


def plain_pooled(backend, batch):
    """The plain path of the backend's fused tree on the same batch."""
    import torch

    from gvl_tpu_torch.models.siglip_fused import siglip_fused_apply

    with torch.inference_mode():
        out = siglip_fused_apply(backend.fused, backend.normalize(batch, torch.bfloat16),
                                 backend.config, pool=False, kernels=False)
    return backend.pooled(out)


def run_semantic(dev):
    """Phase 9: SigLIPSemanticEncoder on the fused so400m tower."""
    import numpy as np
    import torch

    from gvl_tpu_torch.perception.semantic import (
        NaFlexConfig,
        SigLIPSemanticEncoder,
        TorchSigLIPBackend,
    )

    start = time.perf_counter()
    config = NaFlexConfig(quant_fused=True)
    encoder = SigLIPSemanticEncoder.with_random_tower(config, device=dev,
                                                      seed=SEMANTIC_SEED)
    fused = encoder.backend
    torch.cuda.synchronize()
    cfg = fused.config
    log("semantic", f"so400m tower (hidden {cfg.hidden_size}, {cfg.num_layers} layers, "
        f"{cfg.num_heads} heads, FFN {cfg.intermediate_size}), random bf16 weights seed "
        f"{SEMANTIC_SEED}, quantized, calibrated and fused in "
        f"{time.perf_counter() - start:.1f} s")
    frames, frame, masks = semantic_inputs()
    prepared = np.stack([encoder.region_extractor.prepare(f)[0] for f in frames])
    regions = np.stack(encoder.prepare_regions(frame, masks)[0])
    companion = TorchSigLIPBackend(fused.tower, config.dtype,
                                   pool_strategy=config.pool_strategy)
    launches, rates = {}, {}
    for label, run, batch, n in (
            ("images", lambda: encoder.encode_images_batch(frames), prepared, len(frames)),
            ("regions", lambda: np.stack([e.embedding for e in
                                          encoder.encode_masked_regions(frame, masks)]),
             regions, len(masks))):
        reset_launches()
        got = run()
        torch.cuda.synchronize()
        counts = served_launches("semantic", ("w8a8_matmul", "ln_quant",
                                              "attention_fused_qkv"))
        want_counts = dict(FUSED_LAUNCHES, attention_fused_qkv=cfg.num_layers)
        if any(counts[k] != v for k, v in want_counts.items()):
            raise AssertionError(f"semantic {label}: launches {counts}, one forward "
                                 f"launches {want_counts}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if got.shape != (n, cfg.hidden_size):
            raise AssertionError(f"semantic {label}: embeddings {got.shape}")
        check_cosine("semantic", f"{label} ({n}): kernel path vs plain path", got,
                     plain_pooled(fused, batch), COS_KERNEL_PLAIN)
        with uncounted():
            _, bf16 = companion(batch)
            check_cosine("semantic", f"{label} ({n}): fused W8A8 vs bf16 tower", got,
                         bf16, COS_FUSED_BF16)
            _, s_fused = timed_encode(run)
            _, s_bf16 = timed_encode(lambda: companion(batch))
        rates[label] = (n / s_fused, n / s_bf16)
        log("semantic", f"{label}: fused {n / s_fused:.1f}/s ({1e3 * s_fused:.1f} ms per "
            f"call), bf16 tower {n / s_bf16:.1f}/s ({1e3 * s_bf16:.1f} ms); launches "
            f"{ {k: v for k, v in counts.items() if v} }")
    log("semantic", f"images/s fused {rates['images'][0]:.1f} bf16 {rates['images'][1]:.1f};"
        f" regions/s fused {rates['regions'][0]:.1f} bf16 {rates['regions'][1]:.1f}")
    with uncounted():     # every seed is logged before a shortfall raises
        worst = []
        for seed in REGION_SEEDS:
            frame, masks = region_inputs(np.random.default_rng(seed))
            got = np.stack([e.embedding for e in encoder.encode_masked_regions(frame, masks)])
            _, bf16 = companion(np.stack(encoder.prepare_regions(frame, masks)[0]))
            cos = cosines(got, bf16)
            worst.append(float(cos.min()) if np.isfinite(got).all() else float("nan"))
            log("semantic", f"regions ({len(masks)}), seed {seed}: fused W8A8 vs bf16 tower "
                f"pooled cosine min {cos.min():.6f} mean {cos.mean():.6f}")
    if not all(w >= COS_FUSED_BF16 for w in worst):
        raise AssertionError(f"semantic: regions fused vs bf16 cosine minima {worst} "
                             f"(seeds {REGION_SEEDS}), limit {COS_FUSED_BF16}")
    return launches, encoder, prepared


def run_packed(dev, encoder, prepared):
    """Phase 10: the packed-head fused tower (B10) against the padded one."""
    import torch

    from gvl_tpu_torch.perception.semantic import FusedSigLIPBackend, calibration_pixels

    padded = encoder.backend
    calib = calibration_pixels(encoder.config, padded.config.image_size, dev)
    packed = FusedSigLIPBackend(padded.tower, pool_strategy=padded.pool_strategy,
                                calib_pixels=calib, packed_attention=True)
    reset_launches()
    _, got = packed(prepared)
    torch.cuda.synchronize()
    counts = served_launches("packed", ("w8a8_matmul", "ln_quant",
                                        "attention_packed_multihead"))
    want_counts = dict(FUSED_LAUNCHES, attention_packed_multihead=padded.config.num_layers)
    if any(counts[k] != v for k, v in want_counts.items()):
        raise AssertionError(f"packed: launches {counts}, one forward launches {want_counts}")
    with uncounted():
        _, want = padded(prepared)
        check_cosine("packed", f"images ({len(prepared)}): packed vs padded heads", got,
                     want, COS_PACKED_PADDED)
        _, s_packed = timed_encode(lambda: packed(prepared))
    log("packed", f"packed heads {len(prepared) / s_packed:.1f} images/s "
        f"({1e3 * s_packed:.1f} ms per batch of {len(prepared)})")
    return counts


# --------------------------------------------------------------------------
# phase 11: the qa_lm arm's perception encoders
# --------------------------------------------------------------------------

def check_share(phase: str, what: str, err: float, limit: float) -> float:
    ok = math.isfinite(err) and err <= limit
    log(phase, f"{what}: {err:.3g} (limit {limit:.3g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{phase}: {what} {err} over {limit}")
    return err


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - start)


def run_perception(dev):
    """Phase 11: each encoder of the qa_lm arm served once through its entry
    point (launches counted), then held against its plain path."""
    import copy

    import numpy as np
    import torch

    from gvl_tpu_torch.audio.mel import log_mel_spectrogram
    from gvl_tpu_torch.audio.processor import AudioConfig, AudioProcessor
    from gvl_tpu_torch.models.sam import hash_tokenize
    from gvl_tpu_torch.models.whisper import greedy_decode_cached
    from gvl_tpu_torch.nn.layers import set_flash_kernel
    from gvl_tpu_torch.ops.attention import flash_attention
    from gvl_tpu_torch.perception import encoders as E
    from gvl_tpu_torch.perception.ocr_model import _nn_resize, _to_gray, crop_to_input
    from gvl_tpu_torch.runtime.resize import resize_image
    from gvl_tpu_torch.training.asr_train import BOS_ID

    start = time.perf_counter()
    enc = E.random_encoders(dev, PERCEPTION_SEED)
    queries, descs = E.retrieval_texts(RETRIEVAL_TEXTS, PERCEPTION_SEED)
    frames = E.gameplay_frames(PERCEPTION_FRAMES, seed=PERCEPTION_SEED)
    hud = E.hud_frames(OCR_FRAMES, seed=PERCEPTION_SEED)
    audio = E.soundtrack(EVENT_SECONDS, seed=PERCEPTION_SEED)
    speech = E.soundtrack(6 * ASR_CHUNKS, seed=PERCEPTION_SEED + 1)
    processor = AudioProcessor(AudioConfig(max_audio_length=6.0, chunk_overlap=0.0),
                               asr_backend=enc.asr, event_backend=enc.events)
    concepts = list(E.CONCEPTS)
    served = {
        "retriever": lambda: enc.retriever.encode(descs + queries),
        "segmenter": lambda: enc.segmenter.segment_batch(
            frames, list(range(len(frames))), concepts),
        "ocr": lambda: enc.ocr.batch(hud),
        "audio events": lambda: processor.detect_audio_events(audio, 16000),
        "byte ASR": lambda: processor.transcribe(speech, 16000),
    }
    with uncounted():       # first calls: lazy kernel loads, allocator growth
        for fn in served.values():
            fn()
    torch.cuda.synchronize()
    log("perception", f"encoders at their trained geometry, random weights seed "
        f"{PERCEPTION_SEED}, built and warmed in {time.perf_counter() - start:.1f} s")

    reset_launches()
    walls, flash_by = {}, {}
    for name, fn in served.items():
        before = flash_attention.launches
        walls[name] = wall_ms(fn)
        flash_by[name] = flash_attention.launches - before
    launches = served_launches("perception", ("flash_attention",))
    smi = nvidia_smi()
    for name in served:
        log("perception", f"{name}: {walls[name]:.1f} ms wall per call (host clock), "
            f"{flash_by[name]} flash_attention launches; {smi}")
    for name in ("retriever", "segmenter", "byte ASR"):
        if not flash_by[name]:
            raise AssertionError(f"perception: {name} launched no flash_attention")
    segments = processor.transcribe(speech, 16000)
    log("perception", f"byte ASR: {len(segments)} segments of {ASR_CHUNKS} chunks")

    with uncounted(), torch.inference_mode():
        # retriever: kernel path against plain path, embeddings and top-1
        got_q, got_d = enc.retriever.encode(queries), enc.retriever.encode(descs)
        set_flash_kernel(enc.retriever.tower, False)
        want_q, want_d = enc.retriever.encode(queries), enc.retriever.encode(descs)
        set_flash_kernel(enc.retriever.tower, True)
        check_share("perception", f"retriever ({2 * RETRIEVAL_TEXTS} texts): embedding "
                    "max abs err", float(max(np.abs(got_q - want_q).max(),
                                             np.abs(got_d - want_d).max())), RETRIEVER_TOL)
        top_got, top_want = (got_q @ got_d.T).argmax(1), (want_q @ want_d.T).argmax(1)
        if not np.array_equal(top_got, top_want):
            raise AssertionError(f"perception: retriever top-1 differs on "
                                 f"{int((top_got != top_want).sum())} queries")
        log("perception", f"retriever: top-1 over the {RETRIEVAL_TEXTS}-entry index equal "
            f"for all {RETRIEVAL_TEXTS} queries")

        # segmenter: the backend's model on the frames it was served
        backend = enc.segmenter.backend
        size = backend.config.image_size
        px = torch.from_numpy(np.stack([resize_image(f, size, size) for f in frames]))
        px = px.to(dev).float() / 255.0
        tokens = torch.from_numpy(np.stack([hash_tokenize(c, 4096) for c in concepts]))
        got = backend.model(px, tokens.to(dev))
        set_flash_kernel(backend.model, False)
        want = backend.model(px, tokens.to(dev))
        set_flash_kernel(backend.model, True)
        scale = want["mask_logits"].abs().max().item()
        check_share("perception", f"segmenter ({len(frames)} frames x {len(concepts)} "
                    f"concepts): mask logits max abs err per max |logit| {scale:.3g}",
                    max_err(got["mask_logits"], want["mask_logits"]) / scale,
                    MASK_LOGIT_SHARE)
        flips = ((got["mask_logits"] > 0) != (want["mask_logits"] > 0)).float().mean().item()
        check_share("perception", "segmenter: share of flipped mask cells", flips,
                    MASK_FLIP_SHARE)
        check_share("perception", "segmenter: scores max abs err",
                    max_err(got["scores"], want["scores"]), SCORE_TOL)

        # OCR: detector and v2 recognizer on the card against the CPU
        cfg = enc.ocr.config
        canvases = np.stack([_nn_resize(_to_gray(f), cfg.det_height, cfg.det_width)
                             for f in hud])[..., None].astype(np.float32)
        crops = np.stack([crop_to_input(_to_gray(f)[40:90, 20:400], cfg) for f in hud])
        for name, net, x in (("detector", enc.ocr.detector, canvases),
                             ("v2 recognizer", enc.ocr.recognizer, crops[..., None])):
            got = net(torch.from_numpy(x).to(dev)).cpu()
            want = copy.deepcopy(net).cpu()(torch.from_numpy(x))
            check_share("perception", f"OCR {name} ({len(hud)} frames): logits max abs err "
                        f"per max |logit| {want.abs().max().item():.3g}, card vs CPU",
                        max_err(got, want) / want.abs().max().item(), OCR_LOGIT_SHARE)

        # event net: the card against the CPU
        n = len(audio) // 16000
        wavs = torch.from_numpy(audio[: n * 16000].reshape(n, 16000))
        got = enc.events.probabilities(wavs.to(dev)).cpu()
        cpu_events = copy.copy(enc.events)
        cpu_events.net = copy.deepcopy(enc.events.net).cpu()
        check_share("perception", f"event net ({n} s): probabilities max abs err, card vs "
                    "CPU", max_err(got, cpu_events.probabilities(wavs)), EVENT_PROB_TOL)

        # byte ASR: encoder states and greedy tokens, kernel path vs plain path
        model = enc.asr.model
        chunks = torch.from_numpy(speech.reshape(ASR_CHUNKS, -1)).to(dev)
        mel = log_mel_spectrogram(chunks)
        prompts = torch.full((ASR_CHUNKS, 1), BOS_ID, device=dev)
        steps = enc.asr.config.max_target_positions - 1
        got_states = model.encoder(mel)
        got_tokens = greedy_decode_cached(model, mel, prompts, steps)
        set_flash_kernel(model, False)
        want_states = model.encoder(mel)
        want_tokens = greedy_decode_cached(model, mel, prompts, steps)
        set_flash_kernel(model, True)
        check_share("perception", f"byte ASR ({ASR_CHUNKS} windows): encoder states max abs "
                    "err", max_err(got_states, want_states), ASR_STATE_TOL)
        differ = (got_tokens != want_tokens).nonzero()
        if len(differ):
            row, col = differ[0].tolist()
            raise AssertionError(
                f"perception: byte ASR greedy tokens differ first at window {row}, step "
                f"{col}: kernel {got_tokens[row, :col + 1].tolist()}, plain "
                f"{want_tokens[row, :col + 1].tolist()}")
        log("perception", f"byte ASR: greedy token streams equal ({ASR_CHUNKS} windows x "
            f"{got_tokens.shape[1]} positions)")
    return launches


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    from gvl_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1

    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{smi}; torch {torch.__version__} (CUDA {torch.version.cuda}),"
        f" {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    build = _build.build()
    _build.library()
    log("build", f"nvcc {build.seconds:.1f} s: {len(build.compiles)} compiles started "
        f"together, then {' '.join(build.command)}"
        if build.command else f"library already built at {build.path}")

    rows = check_kernels(dev) + check_quant_kernels(dev)
    served = []
    qa_launches, backend, answers, prompts = run_qa(dev)
    served.append(qa_launches)
    launches_8b, cfg_8b, params_8b = run_8b(dev)
    served.append(launches_8b)
    batch_launches, batch_engine = run_qa_batch(dev, backend, answers, prompts)
    served.append(batch_launches)
    served.append(run_http(dev, batch_engine, prompts))
    del batch_engine
    served.append(run_session_lookup(dev, backend, prompts))
    del backend
    served.append(run_8b_scan(dev, cfg_8b, params_8b))
    del params_8b
    torch.cuda.empty_cache()
    semantic_launches, encoder, prepared = run_semantic(dev)
    served.append(semantic_launches)
    served.append(run_packed(dev, encoder, prepared))
    del encoder, prepared
    torch.cuda.empty_cache()
    served.append(run_perception(dev))
    launches = {name: sum(run.get(name, 0) for run in served) for name in served[0]}
    log("launches", f"served paths (phases 3-11): {launches}")
    missing = [name for name, n in launches.items() if n == 0 and name not in UNSERVED]
    if missing:
        raise AssertionError(f"kernels not launched on a served path: {missing}")
    for row in rows:
        row["launches"] = launches[row["name"]]

    faulthandler.cancel_dump_traceback_later()
    print(nvidia_smi(), flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "bound_peak", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: row[k] for k in keys + ("pairs", "lines") if k in row}
                                  for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
