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
   attention and its MAP head and at Qwen3-VL's tower (``lines`` of row
   1), and the int8 product
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
    per call of each encoder;
12. the ``qa_lm`` arm end to end (``gvl_tpu_torch.pipeline``): seeded
    random checkpoints of the segmenter, event net, byte ASR and retriever
    at their trained geometry, written in the repository's format (the
    trained files are not in the card's copy, and each ladder would take
    its fake without them), every ladder asserted to resolve to its model;
    ``process_video`` on one synthetic clip with audio and 8 synthetic
    samples of the arm answered through ``FullPipelineRunner`` on the
    trained QA model (wall ms per stage and per answer, launches per
    answer), then the same through the plain path (timelines, knowledge
    bases and prompts equal byte for byte, answers up to one), device ms
    and busy share per stage (profiler), BENCH_r05's pipeline QA figure
    (``evaluate_qa_lm(pipeline=True)``, n 32 at seeds 77 and 1234, within
    4 of 38/64), and ``gvl_tpu_torch.entry.entry()`` at the 8B geometry;
13. the ``gvp_light`` and ``gvp_full`` arms end to end (the ``light``
    preset's segmenter-free route: zero-shot mini-SigLIP labels of motion
    proposals and whole-frame embeddings; then the segmenter, region
    embeddings, HiCo at its head of 176 and 8 fps; then with VideoMAE on):
    seeded random checkpoints of the mini-SigLIP pair, the clip classifier
    and HiCo beside phase 12's (HiCo's fixed ``outputs/hico_params.npz``
    is met by serving from a working directory that holds the seeded file
    there; the repository's files are not touched), the labeler's and the
    clip heads' biases nudged so that the random models emit events, every
    ladder asserted to resolve to its model, the arms served through
    ``FullPipelineRunner`` with the flash kernel's launches counted per
    model, then each run again through its plain path
    (``nn.layers.plain_attention``: no kernel may launch) with timelines,
    knowledge bases, the grounded fake's messages and answers equal and
    confidences within 1e-4; per stage of one clip of each run, the wall
    (``StageTimer``), device ms, busy share, launches and top kernels;
14. the command-line slice: a ``.y4m`` clip (with its ``.wav``) written by
    the port's ``write_y4m``, read through the native prefetch ring at
    strides 1, 2 and 8 byte-equal to the direct native reader, and closed
    early; ``process_video`` of the ``qa_lm`` arm and of ``gvp_full`` on it
    (seeded checkpoints as in phases 12 and 13), sequential, batched and
    pipelined, each mode against its plain path (no kernel may launch) and
    against the sequential path (events and knowledge bases equal; the
    region embeddings as the JAX package gives them), with wall per clip,
    device ms and busy share; whether batched segmentation keeps the card
    busy while the host prepares the next chunk, with page-locked and with
    pageable uploads; ``python -m gvl_tpu_torch.scripts.realtime_inference``
    as two processes (``--query``, and ``--batched``): exit 0 and the
    ``Timeline:`` line of the same run in process; a seeded rank-32 LoRA
    adapter (every ``lora_b`` non-zero, the in-repository layout) merged
    into the trained QA model through ``create_reasoning_core(lora_path=)``
    and 8 held-out answers against its plain path; the 8B geometry at full
    depth with ``scan_layers``, bf16 and quantized by ``quantize_int8``:
    logits against the bf16 plain path within the phase's bound, tokens/s,
    ms and CUDA launches per decode step of each;
15. Qwen3-VL-8B at the JAX package's geometry (vision tower 1152 wide, 27
    blocks of 16 heads of 72, DeepStack taps 8/16/24; the 36-layer
    decoder) on seeded bf16 weights drawn on the card, served through
    ``Qwen3VLChatBackend`` behind ``ReasoningCore`` (the hashing
    retriever, the port's ``ByteTokenizer``, temperature 0, 16 new
    tokens): two questions over a small timeline, each with a seeded 720 x
    1280 synthetic frame, at image sizes 448 and 256; per answer B1
    launches 27 per frame + 36 and B2 = B3 = 36 per decode step; the plain
    path launches none; the tower's outputs and the prefill logits against
    the plain path and an f32 evaluation of the same weights, the first
    token on both paths, the other frame's logits apart; tower ms, prefill
    and decode wall and device ms, CUDA launches, busy share, tokens/s and
    peak memory;
16. the evaluation entry points on the ``qa_lm`` and ``gvp_light`` arms,
    from a working directory holding phase 13's seeded checkpoints where
    the presets look for them (its nudges and phase 12's speech nudge; the
    trained QA model): ``python -m gvl_tpu_torch.eval.run_phase1`` on 8
    synthetic glitchbench samples as two processes, one after the other
    (the second caches no video and gives the first's predictions; no
    sample errs; the card's allocator peak recorded; each process's
    launches counted per arm), the same samples in process through
    ``PhaseEvaluator`` on the kernel path and on the plain path (answers
    at most one apart per arm; per-arm accuracy, Stage A and B seconds,
    launches per sample), ``run_phase3`` and ``eval_harness --mock``
    (their JSON layout), ``extract_features`` on a 4 s clip kernel path
    against plain path and the projector demo over its embeddings,
    ``smoke_test``, and the single-frame ``BenchmarkModelRunner`` on 4
    samples; within ``EVAL_BUDGET_S``.

Kernel launch counts are zeroed just before each served run (the kernel
path of phases 3 to 16) and read just after it; each run must have launched
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
import logging
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

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
# phase 12: the qa_lm arm end to end on the trained QA model, its encoders at
# their trained geometry with seeded random weights written as checkpoints
# (seed 12); the arm's synthetic samples (loader "arm", seed 42, the first 8:
# 4 visual, 2 speech and 2 audio-implication questions over 10 and 20 s clips)
ARM_SEED, ARM_LOADER, ARM_LOADER_SEED, ARM_SAMPLES = 12, "arm", 42, 8
ARM_ANSWER_SLACK = 1        # kernel vs plain path answers that may differ (bf16 ties)
# added to the seeded event net's speech logit, so that the byte ASR, gated on
# speech windows, runs on the clips (random logits lie within a few units)
ARM_SPEECH_MARGIN = 30.0
# BENCH_r05's qa_lm_pipeline_acc 0.594: evaluate_qa_lm(pipeline=True), n 32 at
# seeds 77 and 1234, max_len 4096, 38 of 64 answers
PIPELINE_SEEDS, PIPELINE_SAMPLES, PIPELINE_MAX_LEN = (77, 1234), 32, 4096
PIPELINE_WANT, PIPELINE_SLACK = 38, 4
# phase 13: the gvp_light and gvp_full arms (grounded fake answers) on seeded
# random checkpoints of every encoder, the mini-SigLIP pair, the clip
# classifier and HiCo at their trained geometry (seed 13); the samples of
# phase 1's first loader ("glitchbench", seed 42): the first 8 for gvp_light,
# the first 4 for gvp_full and the first 2 with VideoMAE on (the synthetic
# clips are drawn at 2 fps, so gvp_full's 8 fps decodes 20 or 40 frames)
GVP_SEED, GVP_LOADER, GVP_LOADER_SEED = 13, "glitchbench", 42
GVP_LIGHT_SAMPLES, GVP_FULL_SAMPLES, GVP_VIDEOMAE_SAMPLES = 8, 4, 2
GVP_CONF_TOL = 1e-4         # zero-shot and motion confidences, kernel vs plain path (f32)
GVP_EMBED_SHARE = 1e-4      # SigLIP and VideoMAE embeddings: share of their largest |value|
# the seeded MAP head's output bias is moved this far along the text
# embedding of one class, so that random towers name motion proposals (their
# cosines otherwise fall below the labeler's 0.5), and the seeded clip heads'
# biases of one direction and one kind are raised, so that the motion events'
# confidence passes 0.6
ZERO_SHOT_CLASS, ZERO_SHOT_MARGIN = "enemy", 100.0
MOTION_DIRECTION, MOTION_KIND, MOTION_MARGIN = "E", "enemy", 30.0
# phase 14: one .y4m clip (written from this synthetic clip, its sound
# beside it as a .wav) read through the native prefetch ring at these
# strides, then processed by the qa_lm arm and gvp_full in each mode
SLICE_SEED = 14
SLICE_CLIP = "synthetic://slice_modes?duration=4&fps=8&entities=player,enemy,boss,item&audio=1"
RING_STRIDES = (1, 2, 8)
MODES = {"sequential": {}, "batched": {"batched": True}, "pipelined": {"pipelined": True}}
OVERLAP_CHUNK = 8           # the segmenter's chunks of SLICE_CLIP's 32 frames, each segmented
CLI_QUERY = "Does a boss appear at any point in this video? Answer Yes or No."
LORA_RANK, LORA_ALPHA, LORA_SAMPLES = 32, 64.0, 8
LORA_MERGE_TOL = 1e-5                   # merged weight against base + (a @ b) * alpha / r, f32
# int8: the 8B geometry at full depth with scan_layers, as the JAX bench
# quantizes it; its logits against the bf16 plain path (relative L2 norm):
# per-channel int8 weights on N(0, 0.02) rows put ~1 % noise on each
# product, 4 % and 5.5 % of the logits at widths 512 and 1024 (CPU, 36
# layers); the kernel path may stray from that by no more than the plain
# path's own int8 error times INT8_ERR_RATIO
INT8_REL_ERR, INT8_ERR_RATIO = 0.25, 1.5
INT8_PROMPT, INT8_STEPS, INT8_CACHE = 128, 16, 512
# phase 15: Qwen3-VL-8B (the JAX package's geometry), seeded bf16 weights,
# served through Qwen3VLChatBackend behind ReasoningCore: two questions,
# each with its own seeded 720 x 1280 synthetic gameplay frame, at the
# backend's image sizes 448 (196 visual tokens) and 256 (its default, 64)
VL_SEED = 15
VL_NEW_TOKENS = 16
VL_SIZES = (448, 256)
VL_SCENE, VL_FRAMES = "vl_boss_fight", (1, 5)
VL_QUESTIONS = ("What is the player doing on screen right now?",
                "Is the boss visible in this frame, and where?")
# the tower's outputs, kernel path against plain path (both bf16): relative
# L2 error; 27 bf16 blocks keep it near 1 %, a dropped or doubled key
# block of one head would not stay under it
VL_TOWER_REL = 0.05
# phase 16: the evaluation entry points on phase 13's seeded checkpoints
# (its nudges kept, phase 12's speech nudge added; torch's seed 16); the
# first 8 synthetic samples of phase 1's glitchbench loader (seed 42), a
# 4 s clip for extract_features and 4 samples for the single-frame runner
EVAL_SEED, EVAL_ARMS, EVAL_SAMPLES, EVAL_SINGLE_FRAME = 16, ("qa_lm", "gvp_light"), 8, 4
EVAL_ANSWER_SLACK = 1       # kernel vs plain path answers that may differ, per arm
EVAL_CLIP = "synthetic://eval_features?duration=4&fps=2&entities=player,enemy,item&audio=1"
EVAL_NPZ_SHARE = 1e-4       # extract_features arrays: share of their largest |value|
EVAL_PROCESS_S = 300        # one run_phase1 process
# the whole phase, wall: the same work read 124.8-187.8 s on three card
# hosts (host-bound: two fresh processes and per-clip model loads); the
# budget leaves room for that spread and fails on a hang or a doubling
EVAL_BUDGET_S = 240
# the kernels each arm's served path launches: qa_lm answers with the QA
# model (B1 prefill, B2 + B3 per decode step), gvp_light with the grounded
# fake; both perceive through the encoders (B1)
EVAL_ARM_KERNELS = {"qa_lm": ("flash_attention", "decode_attention", "cache_append"),
                    "gvp_light": ("flash_attention",)}

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

    from gvl_tpu_torch.device_times import kernel_device_ms
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

    # Qwen3-VL-8B's vision tower at a 448-pixel frame: one sequence of 784
    # patches, head 72 padded to 80 by the wrapper, not causal (PERF.md row 1m)
    shape = "Qwen3-VL tower (448 px): q/k/v [1,16,784,72] bf16"
    qt, kt, vt = (randn(1, 16, 784, 72, dtype=torch.bfloat16) for _ in range(3))
    err = assert_close(f"flash_attention {shape}", flash_attention(qt, kt, vt),
                       attention_reference(qt, kt, vt), BF16_TOL)
    line_bound = bound_ms(sum(t.nbytes for t in (qt, kt, vt)) + qt.nbytes,
                          4.0 * 16 * 72 * 784 * 784, torch.bfloat16)
    flash["lines"].append(dict(
        name="flash_attention", shape=shape, max_abs_err=err,
        ms=time_ms(lambda: flash_attention(qt, kt, vt), 50),
        device_ms=kernel_device_ms(lambda: flash_attention(qt, kt, vt), ("flash_attention",)),
        plain_ms=time_ms(lambda: attention_reference(qt, kt, vt), 10),
        bound_ms=line_bound[0], bound_by=line_bound[1], bound_peak=line_bound[2],
        library="SDPA, bf16",
        library_ms=time_ms(lambda: library_flash(qt, kt, vt, False), 50)))

    # the perception encoders' attention, f32 as those models run (PERF.md
    # rows 1c-1k): the segmenter's image encoder (32 frames), its mask
    # decoder's cross-attention (32 frames x 4 concepts, head 32 padded to
    # 64 by the wrapper), the byte ASR's encoder and its cached decode's
    # cross-attention (4 windows, one query row per step); the mini-SigLIP's
    # towers (8 crops, its MAP head, a caption pool of 7), VideoMAE (3
    # windows), HiCo's pool (8 clips, head 176 padded to 192) and head 192
    # itself
    for shape, b, h, sq, sk, d in (
            ("segmenter image encoder: q/k/v [32,6,256,64] f32", 32, 6, 256, 256, 64),
            ("segmenter mask decoder cross-attention: q [128,8,8,32], k/v [128,8,257,32] "
             "f32 (head padded to 64)", 128, 8, 8, 257, 32),
            ("byte ASR encoder: q/k/v [4,4,300,64] f32", 4, 4, 300, 300, 64),
            ("byte ASR decode cross-attention: q [4,4,1,64], k/v [4,4,300,64] f32",
             4, 4, 1, 300, 64),
            ("mini-SigLIP image tower: q/k/v [8,6,64,64] f32", 8, 6, 64, 64, 64),
            ("mini-SigLIP MAP head: q [8,6,1,64], k/v [8,6,64,64] f32", 8, 6, 1, 64, 64),
            ("mini-SigLIP text tower: q/k/v [7,6,32,64] f32", 7, 6, 32, 32, 64),
            ("VideoMAE: q/k/v [3,4,392,64] f32", 3, 4, 392, 392, 64),
            ("HiCo FRAME to CLIP pool: q [8,8,1,176], k/v [8,8,16,176] f32 (head padded "
             "to 192)", 8, 8, 1, 16, 176),
            ("head 192: q/k/v [4,8,256,192] f32", 4, 8, 256, 256, 192)):
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
            device = (f" (device {pair['device_ms']:.4f} ms)"
                      if pair.get("device_ms") is not None else "")
            log("kernels", f"  {pair['name']} at {pair['shape']}: kernel "
                f"{pair['ms']:.4f} ms{device}, plain {pair['plain_ms']:.4f} ms, "
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


def served_launches(phase: str, expected: tuple[str, ...],
                    launches: Optional[dict[str, int]] = None) -> dict[str, int]:
    """The counts since the last reset (or ``launches``, counted so in
    another process); fails unless every kernel of the served path was
    launched, and unless the appends equal the decode attentions (one pair
    launch per layer and step)."""
    launches = kernel_launches() if launches is None else launches
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

    from gvl_tpu_torch.agent.config import ReasoningCoreConfig
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
    gen_cfg = ReasoningCoreConfig(max_new_tokens=48, temperature=0.0)
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



@contextlib.contextmanager
def arm_encoders(plain: bool):
    """The arm's encoders, as ``process_video`` builds them, with every byte
    ASR's transcriptions counted: yields a dict of its calls, the segments
    they returned and the flash_attention launches they made.  With
    ``plain``, every attention goes through its plain version
    (``set_flash_kernel(model, False)``)."""
    from gvl_tpu_torch.audio import processor
    from gvl_tpu_torch.nn.layers import set_flash_kernel
    from gvl_tpu_torch.ops.attention import flash_attention
    from gvl_tpu_torch.perception import batch

    build_segmenter, build_audio_stack = batch.build_segmenter, processor.build_audio_stack
    asr = {"calls": 0, "segments": 0, "flash_attention": 0}

    def segmenter(*a, **kw):
        seg = build_segmenter(*a, **kw)
        if plain:
            set_flash_kernel(seg.backend.model, False)
        return seg

    def audio_stack(*a, **kw):
        proc, embedder = build_audio_stack(*a, **kw)
        if plain:
            set_flash_kernel(proc.asr.model, False)
        transcribe = proc.transcribe

        def counted(*args, **kwargs):
            before = flash_attention.launches
            segments = transcribe(*args, **kwargs)
            asr["calls"] += 1
            asr["segments"] += len(segments)
            asr["flash_attention"] += flash_attention.launches - before
            return segments

        proc.transcribe = counted
        return proc, embedder

    batch.build_segmenter, processor.build_audio_stack = segmenter, audio_stack
    try:
        yield asr
    finally:
        batch.build_segmenter, processor.build_audio_stack = build_segmenter, build_audio_stack


def let_speech_through(ckpts, margin: float) -> None:
    """Adjusts two of the seeded checkpoints so that the arm's gated byte ASR
    runs and writes text, which random weights alone do not make it do: the
    event net's speech logit is raised by ``margin``, so every window loud
    enough to be heard is classified SPEECH (the arm transcribes speech spans
    only); the byte ASR's embedding rows of its special tokens are zeroed,
    so that greedy decoding (its head tied to the embeddings) picks bytes
    and not the end of the text."""
    from pathlib import Path

    from gvl_tpu_torch.audio.event_model import EVENT_CLASSES
    from gvl_tpu_torch.utils.checkpoints import load_flat_npz, save_flat_npz

    tree = load_flat_npz(ckpts.events)
    tree["params"]["head2"]["bias"][EVENT_CLASSES.index("speech")] += margin
    save_flat_npz(tree, ckpts.events)
    path = Path(ckpts.asr, "params.npz")
    tree = load_flat_npz(path)
    tree["decoder"]["embed_tokens"][256:] = 0.0
    save_flat_npz(tree, path)


def serve_arm(runner, samples) -> tuple[list, dict]:
    """Every sample through the runner: its clip's perception (memoized per
    clip), then its answer; raises on a sample that failed.  Returns the
    answers and the kernel launches of perception and of the answers."""
    results = []
    launches = {part: dict.fromkeys(kernel_launches(), 0) for part in ("perception", "answers")}

    def counted(part, call):
        before = kernel_launches()
        out = call()
        for name, n in kernel_launches().items():
            launches[part][name] += n - before[name]
        return out

    for sample in samples:
        counted("perception", lambda: runner._get_processed(sample.video_path))
        result = counted("answers", lambda: runner.run_inference(sample))
        if "error" in result:
            raise AssertionError(f"arm: {sample.sample_id} failed: {result['error']}")
        results.append(result)
    return results, launches


def run_arm(dev):
    """Phase 12: the qa_lm arm end to end: perception on the port's encoders,
    the timeline and knowledge base, and answers through the loop, the
    reasoning core and the QA engine; then the same through the plain path,
    and BENCH_r05's pipeline-rendered QA figure."""
    import tempfile

    import numpy as np
    import torch

    from gvl_tpu_torch.audio.event_model import TorchAudioEventDetector
    from gvl_tpu_torch.audio.processor import build_audio_stack
    from gvl_tpu_torch.device_times import call_profile
    from gvl_tpu_torch.entry import entry
    from gvl_tpu_torch.eval.model_configs import get_model_config
    from gvl_tpu_torch.eval.model_inference import FullPipelineRunner
    from gvl_tpu_torch.eval.samples import SyntheticLoader
    from gvl_tpu_torch.fusion import KnowledgeBaseBuilder, TimelineIndexer
    from gvl_tpu_torch.io.ingest import resolve_video_source
    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine
    from gvl_tpu_torch.nn.layers import set_flash_kernel
    from gvl_tpu_torch.ops.attention import flash_attention
    from gvl_tpu_torch.perception.batch import build_segmenter
    from gvl_tpu_torch.perception.encoders import write_random_checkpoints
    from gvl_tpu_torch.perception.ocr import create_ocr_pipeline
    from gvl_tpu_torch.perception.ocr_model import TorchOCREngine
    from gvl_tpu_torch.perception.segmenter import TorchSegmenterBackend
    from gvl_tpu_torch.pipeline import run_audio_analysis, run_ocr_extraction, \
        run_sam_detection
    from gvl_tpu_torch.training.asr_train import TrainedByteASR
    from gvl_tpu_torch.training.qa_lm_train import evaluate_qa_lm
    from gvl_tpu_torch.training.retriever_train import TrainedTextEmbedder
    from gvl_tpu_torch.utils.profiler import PromptLog

    start = time.perf_counter()
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_arm_")
    ckpts = write_random_checkpoints(workdir.name, dev, ARM_SEED)
    let_speech_through(ckpts, ARM_SPEECH_MARGIN)
    samples = SyntheticLoader(ARM_LOADER, ARM_LOADER_SEED).synthetic_samples(ARM_SAMPLES)
    clip = next(s.video_path for s in samples if "audio=1" in s.video_path)

    def arm_runner():
        runner = FullPipelineRunner(get_model_config("qa_lm"), use_cache=False, device=dev,
                                    embedding_model=ckpts.retriever)
        cfg = runner.preset
        cfg.perception.sam_checkpoint = ckpts.segmenter
        cfg.perception.ocr_backend = "jax"          # TorchOCREngine, seeded random weights
        cfg.audio.event_checkpoint = ckpts.events
        cfg.audio.asr_checkpoint = ckpts.asr
        return runner

    runner = arm_runner()
    cfg = runner.preset
    # every ladder resolves to its model, none to its fake
    segmenter = build_segmenter(cfg, device=dev)
    ocr = create_ocr_pipeline(cfg.perception.ocr_backend, device=dev)
    audio, _ = build_audio_stack(cfg.audio, device=dev)
    ladders = {"segmenter": type(segmenter.backend), "OCR": type(ocr.engine),
               "ASR": type(audio.asr), "events": type(audio.event_backend)}
    want = {"segmenter": TorchSegmenterBackend, "OCR": TorchOCREngine,
            "ASR": TrainedByteASR, "events": TorchAudioEventDetector}
    if ladders != want:
        raise AssertionError(f"arm: ladders resolved to {ladders}, not {want}")
    del segmenter, ocr, audio
    log("arm", f"seeded checkpoints (seed {ARM_SEED}) written in "
        f"{time.perf_counter() - start:.1f} s; ladders: "
        f"{ {k: v.__name__ for k, v in ladders.items()} }; QA model "
        f"{cfg.reasoning.llm_checkpoint}; {len(samples)} samples of loader '{ARM_LOADER}'")

    # the kernel path: process_video on one clip, then every sample's answer
    torch.manual_seed(ARM_SEED)
    reset_launches()
    with arm_encoders(plain=False) as asr:
        processed = runner._get_processed(clip)
        flash_first = flash_attention.launches
        core = processed.loop.reasoning_core
        prompts = core.backend.engine = PromptLog(core.backend.engine)
        results, parts = serve_arm(runner, samples)
    torch.cuda.synchronize()
    launches = served_launches("arm", ("flash_attention", "decode_attention", "cache_append"))
    speech = [e.description for e in processed.timeline.events
              if e.modality.value == "speech"]
    log("arm", f"byte ASR: {asr['calls']} calls over the {len(runner._processed)} clips, "
        f"{asr['segments']} segments, {asr['flash_attention']} flash_attention launches "
        f"(of the {launches['flash_attention']} counted); {len(speech)} speech events in "
        f"{clip}'s timeline, first {speech[0][:60] if speech else None!r}")
    if not speech or asr["flash_attention"] == 0:
        raise AssertionError(f"arm: the byte ASR did not transcribe {clip} on its kernel: "
                             f"{len(speech)} speech events, {asr}")
    if type(core.retriever._embedder) is not TrainedTextEmbedder:
        raise AssertionError(f"arm: retriever embedder {type(core.retriever._embedder)}")
    smi = nvidia_smi()
    stages = ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in processed.timings.items())
    log("arm", f"process_video({clip}): {len(processed.timestamps)} frames, "
        f"{len(processed.timeline.events)} events, "
        f"{len(processed.knowledge_base.entities)} entities; stages (wall, host clock): "
        f"{stages}; {flash_first} flash_attention launches; {smi}")
    per_clip = {}
    for pv in runner._processed.values():
        for k, v in pv.timings.items():
            per_clip.setdefault(k, []).append(1e3 * v)
    log("arm", "stages, mean wall ms over the "
        f"{len(runner._processed)} clips: "
        + ", ".join(f"{k} {np.mean(v):.1f}" for k, v in per_clip.items()))
    gen_ms = [1e3 * r["timings"]["generation"] for r in results]
    served = ("flash_attention", "decode_attention", "cache_append")
    log("arm", f"{len(results)} answers: {np.mean(gen_ms):.1f} ms wall per answer "
        f"(min {min(gen_ms):.1f}, max {max(gen_ms):.1f}), prompts "
        f"{min(map(len, prompts.prompts))}-{max(map(len, prompts.prompts))} bytes; "
        "launches per answer: "
        + ", ".join(f"{k} {parts['answers'][k] / len(results):.1f}" for k in served)
        + f"; per clip's perception (the {len(runner._processed) - 1} other clips): "
        + ", ".join(f"{k} {parts['perception'][k] / (len(runner._processed) - 1):.1f}"
                    for k in served))
    for sample, result in zip(samples, results):
        log("arm", f"{sample.sample_id}: truth {sample.ground_truth!r}, predicted "
            f"{result['predicted']!r}")

    with uncounted():
        # the plain path: every attention through its plain version, the QA
        # engine on its plain route, the same clips and questions; no kernel
        # may launch in it, or it would compare the kernel path with itself
        before = kernel_launches()
        engine = prompts.engine
        plain_runner = arm_runner()
        plain = PromptLog(Qwen3Engine(engine.config.plain(), engine.model.state_dict(),
                                      eos_token_id=EOS_ID, device=dev))
        tower = core.retriever._embedder.tower
        set_flash_kernel(tower, False)
        core.backend.engine = plain
        torch.manual_seed(ARM_SEED)
        try:
            with arm_encoders(plain=True) as plain_asr:
                plain_runner._get_processed(clip)
                plain_results, _ = serve_arm(plain_runner, samples)
        finally:
            set_flash_kernel(tower, True)
            core.backend.engine = prompts
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in kernel_launches().items() if n != before[k]}
    if launched:
        raise AssertionError(f"arm: the plain path launched kernels: {launched}")
    if plain_runner._processed[clip].loop.reasoning_core is not core:
        raise AssertionError("arm: the plain path answered through another reasoning core "
                             "than the one whose engine and retriever it made plain")
    if (plain_asr["calls"], plain_asr["segments"]) != (asr["calls"], asr["segments"]):
        raise AssertionError(f"arm: byte ASR on the plain path {plain_asr}, on the kernel "
                             f"path {asr}")
    for video, pv in runner._processed.items():
        other = plain_runner._processed[video]
        if (pv.timeline.build_structured_transcript()
                != other.timeline.build_structured_transcript()
                or pv.knowledge_base.export_for_llm() != other.knowledge_base.export_for_llm()):
            raise AssertionError(f"arm: timeline or knowledge base of {video} differs "
                                 "between the kernel and the plain path")
    if plain.prompts != prompts.prompts:
        differ = sum(a != b for a, b in zip(plain.prompts, prompts.prompts))
        raise AssertionError(f"arm: {differ} of {len(prompts.prompts)} prompts differ "
                             "between the kernel and the plain path")
    agree = sum(a["raw_response"] == b["raw_response"]
                for a, b in zip(results, plain_results))
    log("arm", f"plain path: timelines, knowledge bases and {len(prompts.prompts)} prompts "
        f"equal byte for byte; answers equal {agree}/{len(results)}")
    if agree < len(results) - ARM_ANSWER_SLACK:
        raise AssertionError(f"arm: kernel and plain paths agree on {agree} of "
                             f"{len(results)} answers")

    with uncounted():
        # device ms and busy share per stage and per answer (profiler, CUDA)
        frames = resolve_video_source(clip, fps=cfg.inference.fps)
        profiles = {
            "sam_detection": lambda: run_sam_detection(
                frames, cfg, TimelineIndexer(), KnowledgeBaseBuilder(), device=dev),
            "audio_analysis": lambda: run_audio_analysis(clip, TimelineIndexer(), cfg,
                                                         device=dev),
            "ocr_extraction": lambda: run_ocr_extraction(frames, TimelineIndexer(), cfg,
                                                         device=dev),
            "answer": lambda: core.reason(
                samples[0].get_prompt(), timeline_indexer=processed.timeline,
                knowledge_base=processed.knowledge_base, track_conversation=False),
        }
        for name, fn in profiles.items():
            got = call_profile(fn, repeats=1)
            log("arm", f"{name}: wall {got['wall_ms']:.1f} ms, device {got['device_ms']:.2f}"
                f" ms (busy {got['busy_share']:.1%}), {got['kernel_launches']:.0f} CUDA "
                f"launches; top {json.dumps({k: round(v, 3) for k, v in list(got['top_kernels_ms'].items())[:3]})}")

    # BENCH_r05's pipeline figure through the arm's QA engine
    with uncounted():
        correct = {}
        for seed in PIPELINE_SEEDS:
            t0 = time.perf_counter()
            got = evaluate_qa_lm(n_samples=PIPELINE_SAMPLES, seed=seed, engine=engine,
                                 pipeline=True, max_len=PIPELINE_MAX_LEN)
            correct[seed] = round(got["accuracy"] * PIPELINE_SAMPLES)
            log("arm", f"pipeline QA seed {seed}: {correct[seed]}/{PIPELINE_SAMPLES} "
                f"(accuracy {got['accuracy']:.4f}), by family "
                f"{json.dumps(got['by_family'], sort_keys=True)}, "
                f"{time.perf_counter() - t0:.1f} s")
    total = sum(correct.values())
    log("arm", f"pipeline QA: {total}/{PIPELINE_SAMPLES * len(PIPELINE_SEEDS)} "
        f"({total / (PIPELINE_SAMPLES * len(PIPELINE_SEEDS)):.4f}; BENCH_r05 "
        f"{PIPELINE_WANT}/64 = 0.594); {nvidia_smi()}")
    if abs(total - PIPELINE_WANT) > PIPELINE_SLACK:
        raise AssertionError(f"arm: pipeline QA {total} correct, not within "
                             f"{PIPELINE_SLACK} of BENCH_r05's {PIPELINE_WANT}")

    # the port's entry(): the 8B layer geometry at depth 4, zero weights
    with uncounted():
        before = flash_attention.launches
        fn, args = entry(dev)
        logits = fn(*args)
        torch.cuda.synchronize()
        ok = (tuple(logits.shape) == (1, 128, 151936) and bool(torch.isfinite(logits).all())
              and flash_attention.launches > before)
        log("arm", f"entry(): logits {tuple(logits.shape)}, max |logit| "
            f"{logits.abs().max().item():.3g}, {flash_attention.launches - before} "
            "flash_attention launches")
        del fn, args, logits
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("arm: entry() gave no finite logits of the expected shape")
    workdir.cleanup()
    return launches


# --------------------------------------------------------------------------
# phase 13: the gvp_light and gvp_full arms
# --------------------------------------------------------------------------

def let_labels_through(ckpts, dev, margin: float) -> None:
    """Moves the seeded mini-SigLIP's MAP-head output bias ``margin`` along
    the labeler's text embedding of ``ZERO_SHOT_CLASS``, so that the random
    image tower names the motion proposals of a clip (its cosines alone stay
    below the labeler's 0.5 threshold); every other weight, and so the
    tower's dependence on its input, is kept."""
    from gvl_tpu_torch.perception.frame_labeler import MiniSigLIPFrameLabeler
    from gvl_tpu_torch.utils.checkpoints import load_flat_npz, save_flat_npz

    labeler = MiniSigLIPFrameLabeler(ckpts.minisiglip, device=dev)
    target = labeler._text_emb[labeler.classes.index(ZERO_SHOT_CLASS)].cpu().numpy()
    path = Path(ckpts.minisiglip, "params.npz")
    tree = load_flat_npz(path)
    tree["vision"]["head"]["o_proj"]["bias"] += margin * target
    save_flat_npz(tree, path)


def let_motion_through(ckpts, margin: float) -> None:
    """Raises the seeded clip classifier's logits of ``MOTION_DIRECTION`` and
    ``MOTION_KIND`` by ``margin``, so that its motion events pass the 0.6
    confidence the pipeline writes them at."""
    from gvl_tpu_torch.training.videomae_train import CONCEPTS, DIRECTION_NAMES
    from gvl_tpu_torch.utils.checkpoints import load_flat_npz, save_flat_npz

    path = Path(ckpts.videomae, "params.npz")
    tree = load_flat_npz(path)
    tree["dir_head"]["bias"][DIRECTION_NAMES.index(MOTION_DIRECTION)] += margin
    tree["kind_head"]["bias"][CONCEPTS.index(MOTION_KIND)] += margin
    save_flat_npz(tree, path)


@contextlib.contextmanager
def b1_by_model():
    """Yields a dict of the flash_attention launches made inside the forward
    of each model of the gvp arms (global module hooks; a model nested in
    another counts in both)."""
    import torch

    from gvl_tpu_torch.models.sam import PromptableSegmenter
    from gvl_tpu_torch.models.siglip import MAPHead, SigLIPTextTower, SigLIPVisionTower
    from gvl_tpu_torch.models.videomae import VideoMAEEncoder
    from gvl_tpu_torch.ops.attention import flash_attention
    from gvl_tpu_torch.temporal.hico import _CrossAttnPool

    def name_of(m):
        if isinstance(m, SigLIPVisionTower):
            return "mini-SigLIP image tower (MAP head included)"
        if isinstance(m, MAPHead):
            return "mini-SigLIP MAP head"
        if isinstance(m, SigLIPTextTower):
            return ("mini-SigLIP text tower" if m.config.max_position == 32
                    else "retriever text tower")
        if isinstance(m, VideoMAEEncoder):
            return "VideoMAE"
        if isinstance(m, _CrossAttnPool):
            return "HiCo pool (head 176)"
        if isinstance(m, PromptableSegmenter):
            return "segmenter"
        return None

    counts, open_calls = {}, {}

    def pre(module, args):
        if name_of(module):
            open_calls[id(module)] = flash_attention.launches

    def post(module, args, out):
        if id(module) in open_calls:
            name = name_of(module)
            counts[name] = counts.get(name, 0) + flash_attention.launches - open_calls.pop(
                id(module))

    hooks = (torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_forward_hook(post))
    try:
        yield counts
    finally:
        for h in hooks:
            h.remove()


class HiCoLoads(logging.Handler):
    """Records where every HiCo compressor took its weights from."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def gvp_runner(arm: str, ckpts, dev, videomae: bool):
    """The arm's runner on the ``light`` preset with every ladder pointed at
    the seeded checkpoints (OCR: a seeded ``TorchOCREngine``)."""
    from gvl_tpu_torch.eval.model_configs import get_model_config
    from gvl_tpu_torch.eval.model_inference import FullPipelineRunner

    runner = FullPipelineRunner(get_model_config(arm), use_cache=False, device=dev,
                                embedding_model=ckpts.retriever)
    p = runner.preset.perception
    p.sam_checkpoint, p.siglip_checkpoint = ckpts.segmenter, ckpts.minisiglip
    p.videomae_checkpoint, p.use_videomae, p.ocr_backend = ckpts.videomae, videomae, "jax"
    runner.preset.audio.event_checkpoint = ckpts.events
    runner.preset.audio.asr_checkpoint = ckpts.asr
    return runner


def gvp_ladders(what: str, cfg, dev, ckpts) -> None:
    """Fails unless every ladder the run's preset reaches resolves to its
    model on the seeded checkpoints."""
    import numpy as np

    from gvl_tpu_torch.audio.event_model import TorchAudioEventDetector
    from gvl_tpu_torch.audio.processor import build_audio_stack
    from gvl_tpu_torch.perception.batch import build_segmenter, build_siglip_encoder
    from gvl_tpu_torch.perception.ocr import create_ocr_pipeline
    from gvl_tpu_torch.perception.ocr_model import TorchOCREngine
    from gvl_tpu_torch.perception.segmenter import TorchSegmenterBackend
    from gvl_tpu_torch.perception.semantic import TorchSigLIPBackend
    from gvl_tpu_torch.temporal.clip_encoder import build_clip_encoder
    from gvl_tpu_torch.temporal.hico import TemporalCompressionModule
    from gvl_tpu_torch.training.asr_train import TrainedByteASR
    from gvl_tpu_torch.training.siglip_train import is_minisiglip_checkpoint
    from gvl_tpu_torch.training.videomae_train import TrainedClipEncoder
    from gvl_tpu_torch.utils.checkpoints import load_flat_npz, resolve_repo_path

    encoder = build_siglip_encoder(cfg, device=dev)
    audio, _ = build_audio_stack(cfg.audio, device=dev)
    got = {"SigLIP encoder": type(encoder.backend), "OCR": type(
        create_ocr_pipeline(cfg.perception.ocr_backend, device=dev).engine),
        "ASR": type(audio.asr), "events": type(audio.event_backend)}
    want = {"SigLIP encoder": TorchSigLIPBackend, "OCR": TorchOCREngine,
            "ASR": TrainedByteASR, "events": TorchAudioEventDetector}
    if cfg.perception.use_sam:
        got["segmenter"] = type(build_segmenter(cfg, device=dev).backend)
        want["segmenter"] = TorchSegmenterBackend
    if cfg.perception.use_videomae:
        got["clip encoder"] = type(build_clip_encoder(cfg, device=dev))
        want["clip encoder"] = TrainedClipEncoder
    labeler_ckpt = resolve_repo_path(cfg.perception.siglip_checkpoint)
    if (got != want or encoder.config.embedding_dim != 384 or labeler_ckpt != ckpts.minisiglip
            or not is_minisiglip_checkpoint(labeler_ckpt)):
        raise AssertionError(f"{what}: ladders resolved to {got}, encoder width "
                             f"{encoder.config.embedding_dim}, labeler {labeler_ckpt}; "
                             f"want {want}, 384, {ckpts.minisiglip}")
    if cfg.temporal.use_hico:
        module = TemporalCompressionModule(device=dev)
        seeded = load_flat_npz(ckpts.hico)["params"]["temporal_pe"]
        if not np.array_equal(module.compressor.temporal_pe.detach().cpu().numpy(), seeded):
            raise AssertionError(f"{what}: HiCo did not load the seeded {ckpts.hico}")
    log("gvp", f"{what}: ladders {({k: v.__name__ for k, v in got.items()})}, labeler and "
        f"encoder on {labeler_ckpt}" + (", HiCo on the seeded compressor"
                                        if cfg.temporal.use_hico else ""))


def serve_gvp(runner, samples, plain: bool):
    """Every sample through the runner (kernel or plain path), the grounded
    fake's messages recorded; returns (results, launches, messages, B1 by
    model, HiCo's weight sources)."""
    from gvl_tpu_torch.nn.layers import plain_attention
    from gvl_tpu_torch.perception import frame_labeler
    from gvl_tpu_torch.utils.profiler import MessageLog

    frame_labeler._LABELER_CACHE.clear()   # each path builds its own labeler
    hico_loads = HiCoLoads()
    hico_logger = logging.getLogger("gvl_tpu_torch.temporal.hico")
    hico_logger.addHandler(hico_loads)
    hico_logger.setLevel(logging.INFO)
    try:
        with (plain_attention() if plain else contextlib.nullcontext()), \
                b1_by_model() as by_model:
            core = runner._get_processed(samples[0].video_path).loop.reasoning_core
            inner = core.backend.backend if isinstance(core.backend, MessageLog) \
                else core.backend
            core.backend = messages = MessageLog(inner)
            results, launches = serve_arm(runner, samples)
    finally:
        hico_logger.removeHandler(hico_loads)
    return results, launches, messages.messages, by_model, hico_loads.messages


def event_rows(pv) -> list:
    return [(e.timestamp, e.modality.value, e.description, e.entity_id)
            for e in pv.timeline.events]


def compare_processed(what: str, pv, other, embeddings: bool = True) -> None:
    """Two processed clips: events, transcripts and knowledge bases equal,
    confidences within GVP_CONF_TOL, and (``embeddings``) the SigLIP and
    VideoMAE embeddings at the same times, within GVP_EMBED_SHARE of their
    largest value."""
    import numpy as np

    if event_rows(pv) != event_rows(other):
        raise AssertionError(f"{what}: the timelines differ")
    conf = max((abs(a.confidence - b.confidence)
                for a, b in zip(pv.timeline.events, other.timeline.events)), default=0.0)
    if conf > GVP_CONF_TOL:
        raise AssertionError(f"{what}: confidences differ by {conf:.3g}")
    if (pv.timeline.build_structured_transcript()
            != other.timeline.build_structured_transcript()
            or pv.knowledge_base.export_for_llm() != other.knowledge_base.export_for_llm()):
        raise AssertionError(f"{what}: transcript or knowledge base differs")
    for name in ("siglip_embeddings", "videomae_embeddings") if embeddings else ():
        got, want = getattr(pv, name), getattr(other, name)
        if [t for t, _ in got] != [t for t, _ in want]:
            raise AssertionError(f"{what}: {name} at other times")
        if want:
            want = np.stack([e for _, e in want])
            share = np.abs(np.stack([e for _, e in got]) - want).max() / np.abs(want).max()
            if share > GVP_EMBED_SHARE:
                raise AssertionError(f"{what}: {name} differ by {share:.3g} of their "
                                     "largest value")


def compare_gvp(what: str, runner, results, messages, plain_runner, plain_results,
                plain_messages) -> None:
    """Kernel path against plain path: events, transcripts, knowledge
    bases, messages and answers equal; confidences within GVP_CONF_TOL,
    embeddings within GVP_EMBED_SHARE of their largest value."""
    for video, pv in runner._processed.items():
        compare_processed(f"{what}: {video}", pv, plain_runner._processed[video])
    if messages != plain_messages:
        raise AssertionError(f"{what}: the messages handed to the backend differ")
    answers = [r["raw_response"] for r in results]
    if answers != [r["raw_response"] for r in plain_results]:
        raise AssertionError(f"{what}: the grounded fake answered differently")


def profile_gvp(what: str, runner, video: str, dev) -> None:
    """Each stage of one clip, called as process_video calls it: the
    StageTimer wall of the served run beside the profiled wall, device ms,
    busy share, CUDA launches and the top device kernels."""
    from gvl_tpu_torch.device_times import call_profile
    from gvl_tpu_torch.fusion import KnowledgeBaseBuilder, TimelineIndexer
    from gvl_tpu_torch.io.ingest import resolve_video_source
    from gvl_tpu_torch.perception.batch import build_segmenter
    from gvl_tpu_torch.perception.frame_labeler import emit_zero_shot_labels
    from gvl_tpu_torch.pipeline import (
        extract_siglip_embeddings,
        extract_videomae_embeddings,
        run_audio_analysis,
        run_hico,
        run_ocr_extraction,
        run_sam_detection,
    )

    cfg, served = runner.preset, runner._processed[video].timings
    frames = resolve_video_source(video, fps=cfg.inference.fps)
    segmenter = build_segmenter(cfg, device=dev)
    stages = {
        "sam_detection": lambda: run_sam_detection(
            frames, cfg, TimelineIndexer(), KnowledgeBaseBuilder(), device=dev),
        "zero_shot_labels": lambda: emit_zero_shot_labels(frames, cfg, TimelineIndexer(),
                                                          device=dev),
        "siglip_embeddings": lambda: extract_siglip_embeddings(frames, segmenter, cfg, dev),
        "videomae_embeddings": lambda: extract_videomae_embeddings(
            frames, cfg, TimelineIndexer(), device=dev),
        "audio_analysis": lambda: run_audio_analysis(video, TimelineIndexer(), cfg, device=dev),
        "ocr_extraction": lambda: run_ocr_extraction(frames, TimelineIndexer(), cfg, device=dev),
        "temporal_compression": lambda: run_hico(frames, TimelineIndexer(), cfg, device=dev),
    }
    if cfg.perception.use_sam:
        segmenter = run_sam_detection(frames, cfg, TimelineIndexer(), KnowledgeBaseBuilder(),
                                      device=dev)
    log("gvp", f"{what}: {video}, {len(frames)} frames; StageTimer (served run): "
        + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in served.items()))
    with uncounted():
        for name, fn in stages.items():
            if name not in served:
                continue
            got = call_profile(fn, repeats=1)
            log("gvp", f"{what} {name}: StageTimer {1e3 * served[name]:.1f} ms, profiled "
                f"wall {got['wall_ms']:.1f} ms, device {got['device_ms']:.2f} ms (busy "
                f"{got['busy_share']:.1%}), {got['kernel_launches']:.0f} CUDA launches; top "
                f"{json.dumps({k: round(v, 3) for k, v in list(got['top_kernels_ms'].items())[:3]})}")


def run_gvp(dev, keep: Optional[Path] = None):
    """Phase 13: the gvp_light and gvp_full arms (and gvp_full with VideoMAE
    on) end to end on seeded checkpoints, each against its plain path; the
    checkpoints (nudged) are moved to ``keep`` at the end when it is given
    (phase 16 serves from them)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from gvl_tpu_torch.eval.samples import SyntheticLoader
    from gvl_tpu_torch.perception.encoders import write_random_checkpoints

    start = time.perf_counter()
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_gvp_")
    ckpts = write_random_checkpoints(Path(workdir.name, "outputs"), dev, GVP_SEED)
    let_labels_through(ckpts, dev, ZERO_SHOT_MARGIN)
    let_motion_through(ckpts, MOTION_MARGIN)
    loader = SyntheticLoader(GVP_LOADER, GVP_LOADER_SEED)
    samples = loader.synthetic_samples(max(GVP_LIGHT_SAMPLES, GVP_FULL_SAMPLES,
                                           GVP_VIDEOMAE_SAMPLES))
    runs = (("gvp_light", "gvp_light", False, samples[:GVP_LIGHT_SAMPLES]),
            ("gvp_full", "gvp_full", False, samples[:GVP_FULL_SAMPLES]),
            ("gvp_full + VideoMAE", "gvp_full", True, samples[:GVP_VIDEOMAE_SAMPLES]))
    log("gvp", f"seeded checkpoints (seed {GVP_SEED}) written in {workdir.name}/outputs and "
        f"nudged in {time.perf_counter() - start:.1f} s; samples of loader '{GVP_LOADER}' "
        f"(seed {GVP_LOADER_SEED}): {[len(r[3]) for r in runs]}")
    here = os.getcwd()
    # HiCo reads outputs/hico_params.npz, which resolves against the working
    # directory first: the seeded file there, the repository's untouched
    os.chdir(workdir.name)
    total = {}
    try:
        for what, arm, videomae, samples in runs:
            t0 = time.perf_counter()
            runner = gvp_runner(arm, ckpts, dev, videomae)
            gvp_ladders(what, runner.preset, dev, ckpts)
            torch.manual_seed(GVP_SEED)
            reset_launches()
            results, parts, messages, by_model, hico_loads = serve_gvp(runner, samples, False)
            torch.cuda.synchronize()
            launches = served_launches(what, ("flash_attention",))
            for name, n in launches.items():
                total[name] = total.get(name, 0) + n
            events = [e for pv in runner._processed.values() for e in pv.timeline.events]
            zero_shot = sum(1 for e in events if (e.entity_id or "").startswith("zs_"))
            # the timeline merges nearby events of one modality, so a HiCo token
            # and a motion event can share one merged description
            motion = sum(1 for e in events if e.modality.value == "temporal"
                         and " moving " in f" {e.description} ")
            hico = sum(1 for e in events if "Temporal context" in e.description)
            log("gvp", f"{what}: {len(results)} answers over {len(runner._processed)} clips "
                f"({sum(len(pv.timestamps) for pv in runner._processed.values())} frames), "
                f"{len(events)} events: {zero_shot} zero-shot, {motion} motion, {hico} HiCo; "
                f"flash_attention launches by model {by_model}; HiCo loads {set(hico_loads)}; "
                f"stages, mean wall ms: " + ", ".join(
                    f"{k} {np.mean([1e3 * pv.timings[k] for pv in runner._processed.values()]):.1f}"
                    for k in next(iter(runner._processed.values())).timings))
            p = runner.preset
            want_b1 = (["mini-SigLIP image tower (MAP head included)", "mini-SigLIP MAP head"]
                       + (["mini-SigLIP text tower"] if not p.perception.use_sam else [])
                       + (["HiCo pool (head 176)"] if p.temporal.use_hico else [])
                       + (["VideoMAE"] if p.perception.use_videomae else []))
            silent = [name for name in want_b1 if not by_model.get(name)]
            if silent:
                raise AssertionError(f"{what}: no flash_attention launch from {silent}")
            if not p.perception.use_sam and not zero_shot:
                raise AssertionError(f"{what}: no zero-shot label events")
            if p.perception.use_videomae and not motion:
                raise AssertionError(f"{what}: no TEMPORAL motion events")
            if p.temporal.use_hico and (not hico or not hico_loads or any(
                    Path(m.rsplit(" from ", 1)[-1]).resolve() != Path(ckpts.hico).resolve()
                    for m in hico_loads)):
                raise AssertionError(f"{what}: HiCo events {hico}, loads {hico_loads}: not "
                                     f"the seeded {ckpts.hico}")
            for sample, result in zip(samples, results):
                log("gvp", f"{what} {sample.sample_id}: truth {sample.ground_truth!r}, "
                    f"predicted {result['predicted']!r}")

            with uncounted():
                # the plain path: a runner of its own, every attention through
                # its plain version; it may launch no kernel
                before = kernel_launches()
                plain_runner = gvp_runner(arm, ckpts, dev, videomae)
                torch.manual_seed(GVP_SEED)
                plain_results, _, plain_messages, _, _ = serve_gvp(plain_runner, samples, True)
                torch.cuda.synchronize()
                launched = {k: n - before[k] for k, n in kernel_launches().items()
                            if n != before[k]}
            if launched:
                raise AssertionError(f"{what}: the plain path launched kernels: {launched}")
            compare_gvp(what, runner, results, messages, plain_runner, plain_results,
                        plain_messages)
            log("gvp", f"{what}: plain path launched no kernel; timelines, knowledge bases, "
                f"{len(messages)} prompts and {len(results)} answers equal, confidences within "
                f"{GVP_CONF_TOL}; {time.perf_counter() - t0:.1f} s; {nvidia_smi()}")
            profile_gvp(what, runner, samples[0].video_path, dev)
    finally:
        os.chdir(here)
        if keep is not None:
            shutil.move(str(Path(workdir.name, "outputs")), keep)
        workdir.cleanup()
    return total


# --------------------------------------------------------------------------
# phase 14: the command-line slice: the native runtime and its prefetch ring,
# batched and pipelined perception, the CLI, LoRA and int8
# --------------------------------------------------------------------------

def write_slice_clip(workdir: Path) -> Path:
    """SLICE_CLIP's frames as a 4:2:0 ``.y4m`` by the port's ``write_y4m``,
    its sound beside it as a 16-bit ``.wav`` (what ``run_audio_analysis``
    reads for a clip on disk)."""
    import wave

    import numpy as np

    from gvl_tpu_torch.io.video import SyntheticVideo, write_y4m

    synth = SyntheticVideo.from_url(SLICE_CLIP)
    path = workdir / "slice_modes.y4m"
    write_y4m(path, [synth.frame(i) for i in range(synth.num_frames)], synth.fps)
    audio, rate = synth.audio()
    with wave.open(str(path.with_suffix(".wav")), "wb") as wav:
        wav.setnchannels(1)
        wav.setsampwidth(2)
        wav.setframerate(rate)
        wav.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return path


def check_ring(path: Path) -> None:
    """The prefetch ring against the direct native reader: every stride's
    frames byte-equal with timestamps index / fps; a ring closed after one
    frame, its decode thread blocked on a full ring, stops and joins."""
    import numpy as np

    from gvl_tpu_torch.runtime.native import NativePrefetchSource, NativeY4MReader

    reader = NativeY4MReader(path)
    t0 = time.perf_counter()
    direct = list(reader)
    direct_ms = 1e3 * (time.perf_counter() - t0) / len(direct)
    fps = reader.fps
    reader.close()
    for stride in RING_STRIDES:
        ring = NativePrefetchSource(path, capacity=4, stride=stride)
        t0 = time.perf_counter()
        got = list(ring)
        ring_ms = 1e3 * (time.perf_counter() - t0) / max(len(got), 1)
        ring.close()
        want = [(i / fps, f) for i, f in enumerate(direct) if i % stride == 0]
        if ([t for t, _ in got] != [t for t, _ in want]
                or not all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))):
            raise AssertionError(f"ring: stride {stride} differs from the direct reader")
        log("ring", f"stride {stride}: {len(got)} frames byte-equal to the direct reader; "
            f"{ring_ms:.3f} ms per frame through the ring, {direct_ms:.3f} direct")
    t0 = time.perf_counter()
    ring = NativePrefetchSource(path, capacity=2)
    next(iter(ring))
    time.sleep(0.05)
    ring.close()
    log("ring", f"closed after one frame with the decoder blocked: "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")


def profile_once(fn) -> dict:
    """One call of ``fn`` under the profiler: device ms and CUDA launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gvl_tpu_torch.device_times import _device_us, _launch_counts

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel = _device_us(prof)
    launches, _ = _launch_counts(prof)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:3]
    return {"device_ms": sum(per_kernel.values()) / 1e3, "launches": launches,
            "top": {k[:60]: round(v / 1e3, 3) for k, v in top}}


def slice_preset(arm: str, ckpts, dev):
    """The arm's preset with every ladder on the seeded checkpoints."""
    from gvl_tpu_torch.eval.model_configs import get_model_config
    from gvl_tpu_torch.eval.model_inference import FullPipelineRunner

    cfg = FullPipelineRunner(get_model_config(arm), use_cache=False, device=dev,
                             embedding_model=ckpts.retriever).preset
    p = cfg.perception
    p.sam_checkpoint, p.siglip_checkpoint, p.ocr_backend = (ckpts.segmenter, ckpts.minisiglip,
                                                            "jax")
    cfg.audio.event_checkpoint, cfg.audio.asr_checkpoint = ckpts.events, ckpts.asr
    return cfg


def run_modes(dev, clip: Path, ckpts) -> dict:
    """Sequential, batched and pipelined ``process_video`` of the qa_lm arm
    and of gvp_full on ``clip``: each mode's kernel path against its plain
    path (``plain_attention``: no kernel may launch), each mode against the
    sequential path as the JAX package behaves on the CPU, wall per clip,
    device ms and busy share per mode."""
    import torch

    from gvl_tpu_torch.nn.layers import plain_attention
    from gvl_tpu_torch.pipeline import process_video

    total = {}
    for arm in ("qa_lm", "gvp_full"):
        cfg = slice_preset(arm, ckpts, dev)
        with uncounted():
            # a first clip builds the loop's engine and loads kernels lazily:
            # not part of any mode's wall
            process_video(str(clip), cfg, use_cache=False, device=dev,
                          embedding_model=ckpts.retriever)
        done = {}
        for mode, kw in MODES.items():
            def run():
                return process_video(str(clip), cfg, use_cache=False, device=dev,
                                     embedding_model=ckpts.retriever, **kw)

            torch.manual_seed(SLICE_SEED)
            reset_launches()
            t0 = time.perf_counter()
            pv = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = served_launches(f"{arm} {mode}", ("flash_attention",))
            for name, n in launches.items():
                total[name] = total.get(name, 0) + n
            with uncounted():
                before = kernel_launches()
                torch.manual_seed(SLICE_SEED)
                with plain_attention():
                    plain = run()
                torch.cuda.synchronize()
                launched = {k: n - before[k] for k, n in kernel_launches().items()
                            if n != before[k]}
                prof = profile_once(run)
            if launched:
                raise AssertionError(f"{arm} {mode}: the plain path launched {launched}")
            compare_processed(f"{arm} {mode}, kernel against plain path", pv, plain)
            perception = sum(v for k, v in pv.timings.items()
                             if k not in ("loop_init", "frame_extraction"))
            log("modes", f"{arm} {mode}: {len(pv.timestamps)} frames, "
                f"{len(pv.timeline.events)} events, {len(pv.siglip_embeddings)} embeddings; "
                f"wall {1e3 * wall:.1f} ms per clip (perception stages "
                f"{1e3 * perception:.1f} ms: " + ", ".join(
                    f"{k} {1e3 * v:.1f}" for k, v in pv.timings.items()) + "); device "
                f"{prof['device_ms']:.2f} ms (busy {prof['device_ms'] / (1e3 * wall):.1%}), "
                f"{prof['launches']:.0f} CUDA launches, flash_attention "
                f"{launches['flash_attention']}; top {json.dumps(prof['top'])}; plain path "
                f"equal, no kernel launched")
            done[mode] = pv
        seq = done["sequential"]
        for mode in ("batched", "pipelined"):
            # the JAX package's batched and pipelined paths give the sequential
            # events and knowledge base; their region embeddings are each
            # segmented frame's detections (tests/test_torch_batched.py)
            compare_processed(f"{arm} {mode} against sequential", done[mode], seq,
                              embeddings=arm == "qa_lm")
        log("modes", f"{arm}: batched and pipelined timelines and knowledge bases equal "
            f"to the sequential path's; embeddings "
            + ", ".join(f"{m} {len(pv.siglip_embeddings)}" for m, pv in done.items()))
    return total


def check_overlap(dev, ckpts) -> None:
    """Whether batched segmentation keeps the card busy while the host
    prepares the next chunk: SLICE_CLIP's frames, every one segmented, in
    chunks of OVERLAP_CHUNK; after each ``submit`` returns, is the stream
    still busy (the host ran ahead), how long the host spent in ``submit``
    and in ``collect`` (the wait and the mask NMS), and the card's time
    per chunk; page-locked uploads (the served route) against pageable
    ones."""
    import torch

    from gvl_tpu_torch.fusion import KnowledgeBaseBuilder, TimelineIndexer
    from gvl_tpu_torch.io.ingest import resolve_video_source
    from gvl_tpu_torch.perception.batch import build_perception_stack, run_batched_perception

    cfg = slice_preset("gvp_full", ckpts, dev)
    cfg.perception.sam3_fps = cfg.inference.fps
    cfg.perception.use_siglip = cfg.perception.use_ocr = False
    frames = resolve_video_source(SLICE_CLIP, fps=cfg.inference.fps)
    stack = build_perception_stack(cfg, device=dev)
    backend = stack[0].backend
    submit, collect = backend.submit, backend.collect

    def perceive():
        run_batched_perception(frames, cfg, TimelineIndexer(), KnowledgeBaseBuilder(),
                               chunk=OVERLAP_CHUNK, segmenter=stack[0], encoder=stack[1],
                               ocr=stack[2], device=dev)
        torch.cuda.synchronize()

    with uncounted():
        for route in ("page-locked", "pageable"):
            seen = {}

            def timed_submit(*a):
                t0 = time.perf_counter()
                handle = submit(*a)
                seen["submit_ms"] += 1e3 * (time.perf_counter() - t0)
                seen["submits"] += 1
                seen["busy"] += not torch.cuda.current_stream().query()
                return handle

            def timed_collect(*a):
                t0 = time.perf_counter()
                out = collect(*a)
                seen["collect_ms"] += 1e3 * (time.perf_counter() - t0)
                return out

            backend.submit, backend.collect = timed_submit, timed_collect
            pin = torch.Tensor.pin_memory
            if route == "pageable":
                torch.Tensor.pin_memory = lambda self, *a, **k: self
            try:
                for _ in range(2):     # a warm-up, then the counted run
                    seen.update(busy=0, submits=0, submit_ms=0.0, collect_ms=0.0)
                    t0 = time.perf_counter()
                    perceive()
                    wall = 1e3 * (time.perf_counter() - t0)
                counted = dict(seen)     # the profiled run counts again
                prof = profile_once(perceive)
            finally:
                torch.Tensor.pin_memory = pin
                backend.submit, backend.collect = submit, collect
            log("overlap", f"{route} uploads, {len(frames)} frames in chunks of "
                f"{OVERLAP_CHUNK}: wall {wall:.1f} ms; {counted['busy']} of {counted['submits']} "
                f"submits returned with the card still busy; host "
                f"{counted['submit_ms'] / counted['submits']:.2f} ms per submit, "
                f"{counted['collect_ms'] / counted['submits']:.2f} ms per collect; card "
                f"{prof['device_ms'] / counted['submits']:.2f} ms and "
                f"{prof['launches'] / counted['submits']:.0f} launches per chunk; top "
                f"{json.dumps(prof['top'])}")


def run_cli(dev, clip: Path) -> None:
    """``python -m gvl_tpu_torch.scripts.realtime_inference`` on the card as
    a user starts it (the ``light`` preset, ``--query``; and ``--batched``),
    both processes at once: exit 0, and the ``Timeline:`` line of the same
    ``process_video`` run in this process."""
    import os

    from gvl_tpu_torch.config import load_preset
    from gvl_tpu_torch.pipeline import process_video

    cmd = [sys.executable, "-m", "gvl_tpu_torch.scripts.realtime_inference", "--video",
           str(clip), "--no-cache", "--query", CLI_QUERY, "--device", dev.type]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    t0 = time.perf_counter()
    procs = {mode: subprocess.Popen(cmd + flags, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for mode, flags in (("one-shot", []), ("batched", ["--batched"]))}
    want = {}
    for mode, kw in (("one-shot", {}), ("batched", {"batched": True})):
        stats = process_video(str(clip), load_preset("light"), use_cache=False, device=dev,
                              **kw).timeline.get_statistics()
        want[mode] = (f"Timeline: {stats['total_events']} events, "
                      f"{stats['unique_entities']} entities, {stats['duration']:.0f}s span")
    for mode, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        lines = [ln for ln in out.splitlines() if ln.startswith("Timeline:")]
        if proc.returncode != 0 or lines != [want[mode]]:
            raise AssertionError(f"cli {mode}: exit {proc.returncode}, {lines} against "
                                 f"{want[mode]!r}\n{err[-2000:]}")
        answer = out.split(want[mode], 1)[1].strip()
        log("cli", f"{mode}: exit 0, {want[mode]!r} as in process; answer {answer[:80]!r}")
    log("cli", f"both processes in {time.perf_counter() - t0:.1f} s")


def write_seeded_adapter(root: Path, config, seed: int) -> Path:
    """A rank-LORA_RANK adapter over every target of every layer of the QA
    model, ``lora_a`` and ``lora_b`` both non-zero, in the layout of
    ``outputs/lora_adapter`` (``adapter_config.json`` and
    ``adapter_final.npz`` of ``layers_{i}/<module>/<target>/lora_a|b``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, hd, inter = config.hidden_size, config.head_dim, config.intermediate_size
    dims = {"self_attn/q_proj": (d, config.num_heads * hd),
            "self_attn/k_proj": (d, config.num_kv_heads * hd),
            "self_attn/v_proj": (d, config.num_kv_heads * hd),
            "self_attn/o_proj": (config.num_heads * hd, d),
            "mlp/gate_proj": (d, inter), "mlp/up_proj": (d, inter), "mlp/down_proj": (inter, d)}
    arrays = {}
    for i in range(config.num_layers):
        for name, (n_in, n_out) in dims.items():
            arrays[f"layers_{i}/{name}/lora_a"] = rng.normal(0, 0.02, (n_in, LORA_RANK))
            arrays[f"layers_{i}/{name}/lora_b"] = rng.normal(0, 0.02, (LORA_RANK, n_out))
    root.mkdir(parents=True, exist_ok=True)
    np.savez(root / "adapter_final.npz", **{k: v.astype(np.float32) for k, v in arrays.items()})
    (root / "adapter_config.json").write_text(json.dumps({
        "lora_rank": LORA_RANK, "lora_alpha": LORA_ALPHA,
        "targets": [n.split("/")[1] for n in dims], "base_checkpoint": str(QA_CKPT)}))
    return root


def run_lora(dev, workdir: Path) -> dict:
    """A seeded adapter merged into the trained QA model through
    ``create_reasoning_core(lora_path=...)``: the merge against base + (a @
    b) * alpha / r, then LORA_SAMPLES held-out answers through the merged
    engine (B1, B2, B3) against its plain path."""
    import numpy as np
    import torch

    from gvl_tpu_torch.agent.core import create_reasoning_core
    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine
    from gvl_tpu_torch.training.qa_lm_train import evaluate_qa_lm, load_qa_lm

    base_cfg, base = load_qa_lm(QA_CKPT, device=dev)
    adapter = write_seeded_adapter(workdir / "lora_adapter", base_cfg, SLICE_SEED)
    core = create_reasoning_core(checkpoint_path=str(QA_CKPT), lora_path=str(adapter),
                                 device=dev)
    engine = core.backend.engine
    merged = engine.model.state_dict()
    with np.load(adapter / "adapter_final.npz") as z:
        errs = []
        for i in range(base_cfg.num_layers):
            for mod, name in (("self_attn", "q_proj"), ("mlp", "down_proj")):
                a, b = (torch.from_numpy(z[f"layers_{i}/{mod}/{name}/lora_{x}"]).to(dev)
                        for x in "ab")
                want = base[f"layers.{i}.{mod}.{name}.weight"] + (
                    a @ b * (LORA_ALPHA / LORA_RANK)).T
                errs.append(max_err(merged[f"layers.{i}.{mod}.{name}.weight"], want))
    moved = max_err(merged["layers.0.self_attn.q_proj.weight"],
                    base["layers.0.self_attn.q_proj.weight"])
    if max(errs) > LORA_MERGE_TOL or not moved:
        raise AssertionError(f"lora: merge error {max(errs):.3g} (limit {LORA_MERGE_TOL}), "
                             f"change of the base {moved:.3g}")
    timed = TimedEngine(engine)
    reset_launches()
    got = evaluate_qa_lm(n_samples=LORA_SAMPLES, seed=QA_SEED, engine=timed)
    torch.cuda.synchronize()
    launches = served_launches("lora", ("flash_attention", "decode_attention", "cache_append"))
    with uncounted():
        plain = Qwen3Engine(engine.config.plain(), merged, eos_token_id=EOS_ID, device=dev)
        ref = evaluate_qa_lm(n_samples=LORA_SAMPLES, seed=QA_SEED, engine=plain)
    agree = sum(a == b for a, b in zip(got["answers"], ref["answers"]))
    log("lora", f"rank {LORA_RANK}, alpha {LORA_ALPHA}, 7 targets x {base_cfg.num_layers} "
        f"layers merged (max error {max(errs):.3g} against base + delta; the base moved by "
        f"up to {moved:.3g}); {LORA_SAMPLES} answers: accuracy {got['accuracy']:.3f}, "
        f"{timed.summary()}; plain path equal {agree}/{LORA_SAMPLES}; launches {launches}")
    if agree != LORA_SAMPLES:
        raise AssertionError(f"lora: kernel and plain path agree on {agree} of "
                             f"{LORA_SAMPLES} answers")
    return launches


def run_int8(dev) -> dict:
    """The 8B geometry at full depth with scan_layers, bf16 and quantized by
    ``quantize_int8``: prefill and first-step logits of each against the
    bf16 plain path, then tokens/s, ms per decode step and CUDA launches per
    step of both."""
    import dataclasses

    import torch

    from gvl_tpu_torch.device_times import decode_profile
    from gvl_tpu_torch.models.qwen3 import KVCache, Qwen3Config, Qwen3Engine, init_params, \
        quantize_int8

    cfg = Qwen3Config(scan_layers=True, max_cache_length=INT8_CACHE)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SLICE_SEED),
                         dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    qparams = quantize_int8(params, cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    qcfg = dataclasses.replace(cfg, quant_int8=True)
    prompt = torch.randint(0, cfg.vocab_size, (1, INT8_PROMPT),
                           generator=torch.Generator().manual_seed(SLICE_SEED))
    gb = {name: sum(t.numel() * t.element_size() for t in p.values()) / 1e9
          for name, p in (("bf16", params), ("int8", qparams))}
    log("int8", f"{cfg.num_layers} layers at hidden {cfg.hidden_size} (scan_layers): bf16 "
        f"{gb['bf16']:.2f} GB, int8 {gb['int8']:.2f} GB, quantized on the card in "
        f"{quant_s:.2f} s")

    def logits_of(engine, token=None):
        with torch.inference_mode():
            cache = KVCache.zeros(engine.config, 1, device=dev)
            pre, cache = engine.model(prompt.to(dev), positions=torch.arange(
                INT8_PROMPT, device=dev), cache=cache)
            token = pre[:, -1].argmax(-1) if token is None else token
            step, _ = engine.model(token[:, None], positions=torch.tensor(
                [INT8_PROMPT], device=dev), cache=cache)
        return torch.cat([pre[0], step[0]]).float(), token

    def rel(x, ref):
        return ((x - ref).norm() / ref.norm()).item()

    engines = {"bf16": Qwen3Engine(cfg, params, eos_token_id=-1, device=dev),
               "int8": Qwen3Engine(qcfg, qparams, eos_token_id=-1, device=dev)}
    ref, token = logits_of(Qwen3Engine(cfg.plain(), params, eos_token_id=-1, device=dev))
    errs = {}
    for name, engine in engines.items():
        got, _ = logits_of(engine, token)
        plain, _ = logits_of(Qwen3Engine(engine.config.plain(), engine.model.state_dict(),
                                         eos_token_id=-1, device=dev), token)
        errs[name] = (rel(got, ref), rel(plain, ref), bool(torch.isfinite(got).all()))
    log("int8", "logits (prefill and first step) against the bf16 plain path, relative: "
        + ", ".join(f"{n} kernel path {k:.5f}, plain path {p:.5f}"
                    for n, (k, p, _) in errs.items())
        + f" (limits: int8 {INT8_REL_ERR}, kernel path {INT8_ERR_RATIO}x its plain path's)")
    k8, p8, finite = errs["int8"]
    if not finite or k8 > INT8_REL_ERR or k8 > INT8_ERR_RATIO * max(p8, errs["bf16"][0]):
        raise AssertionError(f"int8: logits error {k8:.4f} (plain path {p8:.4f}) out of bounds")
    total = {}
    ids = prompt[0].tolist()
    for name, engine in engines.items():
        reset_launches()
        out = TimedEngine(engine)
        tokens = out.generate(ids, max_new_tokens=INT8_STEPS, temperature=0.0)
        torch.cuda.synchronize()
        launches = served_launches(f"int8 {name}", ("flash_attention",
                                                    "decode_attention_stacked",
                                                    "cache_append_stacked"))
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        with uncounted():
            step = decode_profile(engine, ids, INT8_STEPS)
        log("int8", f"{name}: {len(tokens)} greedy tokens, {out.summary()}; decode step "
            f"wall {step['wall_ms_per_step']:.3f} ms, device {step['device_ms_per_step']:.3f} "
            f"ms (busy {step['busy_share']:.1%}), {step['device_launches_per_step']:.1f} CUDA "
            f"launches per step; top {json.dumps({k: round(v, 3) for k, v in list(step['top_kernels_ms_per_step'].items())[:3]})}")
    del engines, params, qparams
    torch.cuda.empty_cache()
    return total


def run_slice(dev):
    """Phase 14: the ring, the three perception modes of the qa_lm arm and
    gvp_full, the CLI, the LoRA adapter and the int8 8B decoder."""
    import os
    import tempfile

    from gvl_tpu_torch.perception.encoders import write_random_checkpoints

    start = time.perf_counter()
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_slice_")
    root = Path(workdir.name)
    clip = write_slice_clip(root)
    check_ring(clip)
    ckpts = write_random_checkpoints(root / "outputs", dev, SLICE_SEED)
    let_speech_through(ckpts, ARM_SPEECH_MARGIN)
    log("slice", f"{clip.name} and its .wav, seeded checkpoints (seed {SLICE_SEED}) in "
        f"{time.perf_counter() - start:.1f} s")
    served = []
    here = os.getcwd()
    os.chdir(root)      # HiCo's fixed outputs/hico_params.npz: the seeded one
    try:
        served.append(run_modes(dev, clip, ckpts))
        check_overlap(dev, ckpts)
    finally:
        os.chdir(here)
    run_cli(dev, clip)
    served.append(run_lora(dev, root))
    served.append(run_int8(dev))
    workdir.cleanup()
    log("slice", f"phase 14 in {time.perf_counter() - start:.1f} s; {nvidia_smi()}")
    return {name: sum(run.get(name, 0) for run in served) for name in kernel_launches()}


# --------------------------------------------------------------------------
# phase 15: Qwen3-VL-8B behind ReasoningCore
# --------------------------------------------------------------------------

def vl_frames():
    """The phase's two seeded 720 x 1280 gameplay-like frames."""
    from gvl_tpu_torch.io.video import SyntheticVideo

    video = SyntheticVideo(VL_SCENE, duration=4.0, fps=2.0, width=1280, height=720,
                           entities=["player", "enemy", "boss", "item"])
    return [video.frame(i) for i in VL_FRAMES]


def rel_err(x, ref) -> float:
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


def timed_generate(vl, ids, patches, grid, new_tokens: int) -> tuple[float, dict]:
    """Wall ms of one greedy ``generate`` (tower, prefill and decode steps)
    and the profile of another."""
    import torch

    def run():
        vl.generate(ids, patches, grid, max_new_tokens=new_tokens, eos_token_id=-1)

    run()
    torch.cuda.synchronize()
    start = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - start)
    return wall, profile_once(run)


def run_vl(dev):
    """Phase 15: Qwen3-VL-8B served through Qwen3VLChatBackend behind
    ReasoningCore, its launches counted per answer, then the tower and the
    prefill logits held to the plain path and an f32 evaluation."""
    import numpy as np
    import torch

    from gvl_tpu_torch.agent.config import ReasoningCoreConfig
    from gvl_tpu_torch.agent.core import Qwen3VLChatBackend, ReasoningCore
    from gvl_tpu_torch.fusion import ModalityType, TimelineIndexer
    from gvl_tpu_torch.models.byte_tokenizer import ByteTokenizer
    from gvl_tpu_torch.models.qwen3 import Qwen3Config
    from gvl_tpu_torch.models.qwen3vl import Qwen3VL, Qwen3VLVisionConfig, init_vl_params
    from gvl_tpu_torch.nn.layers import set_flash_kernel

    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    vcfg, tcfg = Qwen3VLVisionConfig(), Qwen3Config.qwen3_vl_8b()
    state = init_vl_params(vcfg, tcfg, torch.Generator(device=dev).manual_seed(VL_SEED),
                           torch.bfloat16, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in state.values())
    vl = Qwen3VL(vcfg, tcfg, state, device=dev)
    plain = Qwen3VL(vcfg, tcfg.plain(), state, device=dev)    # the same tensors
    set_flash_kernel(plain.vision, False)
    log("vl", f"Qwen3-VL-8B: tower {vcfg.depth} blocks x {vcfg.num_heads} heads of "
        f"{vcfg.head_dim}, decoder {tcfg.num_layers} layers at {tcfg.hidden_size}; "
        f"{n_params / 1e9:.2f} B bf16 parameters ({2 * n_params / 1e9:.1f} GB) drawn in "
        f"{time.perf_counter() - start:.1f} s")

    timeline = TimelineIndexer()
    for ts, text in ((3.0, "player enters the arena"), (12.0, "boss appears at the gate"),
                     (20.0, "player dodges an attack"), (31.0, "an item drops")):
        timeline.add_event(ts, ModalityType.VISUAL, text)
    frames = vl_frames()
    gen_cfg = ReasoningCoreConfig(embedding_model="hashing", temperature=0.0,
                                  max_new_tokens=VL_NEW_TOKENS)
    launches_total = {}
    prepared = {}        # (size, frame) -> the first question's (ids, patches, grid)
    for size in VL_SIZES:
        backend = Qwen3VLChatBackend(vl, ByteTokenizer(), image_size=size)
        core = ReasoningCore(gen_cfg, backend=backend, device=dev)
        context = core.format_timeline_context(timeline.events)
        for index, frame in enumerate(frames):
            prepared[size, index] = backend._prepare(core.build_prompt(
                VL_QUESTIONS[0], context, current_frame=frame))
        for question, frame in zip(VL_QUESTIONS, frames):
            reset_launches()
            t0 = time.perf_counter()
            answer = core.reason(question, current_frame=frame, timeline_indexer=timeline,
                                 track_conversation=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = served_launches("vl", ("flash_attention", "decode_attention",
                                              "cache_append"))
            steps = vl.last_decode_steps
            want = {"flash_attention": vcfg.depth + tcfg.num_layers,
                    "decode_attention": tcfg.num_layers * steps,
                    "cache_append": tcfg.num_layers * steps}
            log("vl", f"image {size}: {len(backend.last_tokens)} tokens "
                f"{backend.last_tokens} ({steps} decode steps), answer {answer!r}, "
                f"{1e3 * wall:.1f} ms wall")
            if any(launches[k] != n for k, n in want.items()) or any(
                    n for k, n in launches.items() if k not in want):
                raise AssertionError(f"vl: launches {launches}, expected {want}")
            if len(backend.last_tokens) != VL_NEW_TOKENS:
                raise AssertionError(f"vl: {len(backend.last_tokens)} tokens")
            for k, n in launches.items():
                launches_total[k] = launches_total.get(k, 0) + n

    with uncounted():
        plain_backend = Qwen3VLChatBackend(plain, ByteTokenizer(), image_size=VL_SIZES[0])
        core = ReasoningCore(gen_cfg, backend=plain_backend, device=dev)
        reset_launches()
        core.reason(VL_QUESTIONS[0], current_frame=frames[0], timeline_indexer=timeline,
                    track_conversation=False)
        torch.cuda.synchronize()
        if any(kernel_launches().values()):
            raise AssertionError(f"vl: the plain path launched {kernel_launches()}")
        log("vl", f"plain path: no kernel launched; tokens {plain_backend.last_tokens}")

        ids, patches, grid = prepared[VL_SIZES[0], 0]
        ids_b, patches_b, grid_b = prepared[VL_SIZES[0], 1]
        tower_k = vl.encode_vision(patches, grid)
        tower_p = plain.encode_vision(patches, grid)
        logits_k = vl.forward(ids, patches, grid)[0]
        logits_p = plain.forward(ids, patches, grid)[0]
        logits_b = vl.forward(ids_b, patches_b, grid_b)[0]
        # the frame reaches the model: the other frame's prefill logits differ
        if not np.array_equal(ids, ids_b):
            raise AssertionError("vl: the two frames' prompts differ in their ids")
        frame_gap = (logits_k.float() - logits_b.float()).abs().max().item()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        # the f32 evaluation of the same weights (plain path)
        del plain
        truth = Qwen3VL(vcfg, tcfg.plain(), {k: v.float() for k, v in state.items()},
                        device=dev)
        set_flash_kernel(truth.vision, False)
        tower_t = truth.encode_vision(patches, grid)
        logits_t = truth.forward(ids, patches, grid)[0]
        del truth
        torch.cuda.empty_cache()

    names = ["merged"] + [f"deepstack {i}" for i in vcfg.deepstack_visual_indexes]
    outs_k, outs_p, outs_t = ([t[0], *t[1]] for t in (tower_k, tower_p, tower_t))
    for name, k, p, t in zip(names, outs_k, outs_p, outs_t):
        rel_kp, rel_k, rel_p = rel_err(k, p), rel_err(k, t), rel_err(p, t)
        ok = (rel_kp <= VL_TOWER_REL and rel_k <= BF16_ERR_RATIO * rel_p
              and bool(torch.isfinite(k).all()))
        log("vl", f"tower {name} {tuple(k.shape)}: kernel vs plain path {rel_kp:.5f} "
            f"(limit {VL_TOWER_REL}); against f32, kernel path {rel_k:.5f}, plain path "
            f"{rel_p:.5f} (limit {BF16_ERR_RATIO}x); {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"vl: tower {name} strays")
    err_k, err_p = rel_err(logits_k, logits_t), rel_err(logits_p, logits_t)
    last_err = (logits_k[-1].float() - logits_p[-1].float()).abs().max().item()
    top2 = logits_p[-1].float().topk(2).values
    margin = (top2[0] - top2[1]).item()
    first_k, first_p = int(logits_k[-1].argmax()), int(logits_p[-1].argmax())
    ok = err_k <= BF16_ERR_RATIO * err_p and bool(torch.isfinite(logits_k).all())
    log("vl", f"prefill logits {tuple(logits_k.shape)} ({ids.shape[1]} tokens, "
        f"{patches.shape[0] // 4} visual): relative error against f32, kernel path "
        f"{err_k:.5f}, plain path {err_p:.5f} (limit {BF16_ERR_RATIO}x); first token "
        f"{first_k} (plain path {first_p}, top-two margin {margin:.4f}, last-row max abs "
        f"err {last_err:.4f}); the other frame moves the logits by up to {frame_gap:.3f}; "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("vl: prefill logits stray from f32")
    if first_k != first_p and margin >= last_err:
        raise AssertionError(f"vl: first token {first_k} != {first_p} at margin {margin}")
    if not frame_gap > 0:
        raise AssertionError("vl: two frames give the same prefill logits")

    # times: the tower alone, then generate with 1 and with 16 new tokens
    for size in VL_SIZES:
        ids, patches, grid = prepared[size, 0]
        tower_ms = time_ms(lambda: vl.encode_vision(patches, grid), 10)
        with uncounted():
            one_ms, one = timed_generate(vl, ids, patches, grid, 1)
            full_ms, full = timed_generate(vl, ids, patches, grid, VL_NEW_TOKENS)
        steps = VL_NEW_TOKENS - 1
        step_ms = (full_ms - one_ms) / steps
        step_dev = (full["device_ms"] - one["device_ms"]) / steps
        log("vl", f"image {size} ({patches.shape[0]} patches, {ids.shape[1]}-token prompt): "
            f"tower {tower_ms:.3f} ms; tower + prefill {one_ms:.2f} ms wall, "
            f"{one['device_ms']:.2f} ms device ({one['device_ms'] / one_ms:.1%} busy), "
            f"{one['launches']} CUDA launches; decode {step_ms:.3f} ms/step wall, "
            f"{step_dev:.3f} ms device ({step_dev / step_ms:.1%} busy), "
            f"{(full['launches'] - one['launches']) / steps:.1f} CUDA launches/step, "
            f"{1e3 / step_ms:.1f} tokens/s; top {json.dumps(full['top'])}")
    log("vl", f"peak memory {peak:.2f} GiB (bf16 model and both paths' activations), "
        f"phase 15 in {time.perf_counter() - start:.1f} s; {nvidia_smi()}")
    del vl, state
    torch.cuda.empty_cache()
    return launches_total



# --------------------------------------------------------------------------
# phase 16: the evaluation entry points

def eval_ladders(dev, ckpts) -> None:
    """Fails unless, from the phase's working directory, every ladder of the
    two arms that phase 16 seeded resolves to its model on the seeded
    checkpoint; the OCR ladder, not seeded, is named."""
    from gvl_tpu_torch.agent.config import ReasoningCoreConfig
    from gvl_tpu_torch.agent.retriever import make_embedder
    from gvl_tpu_torch.audio.event_model import TorchAudioEventDetector
    from gvl_tpu_torch.audio.processor import build_audio_stack
    from gvl_tpu_torch.eval.model_configs import get_model_config
    from gvl_tpu_torch.eval.model_inference import FullPipelineRunner
    from gvl_tpu_torch.perception.batch import build_segmenter, build_siglip_encoder
    from gvl_tpu_torch.perception.ocr import create_ocr_pipeline
    from gvl_tpu_torch.perception.segmenter import TorchSegmenterBackend
    from gvl_tpu_torch.perception.semantic import TorchSigLIPBackend
    from gvl_tpu_torch.training.asr_train import TrainedByteASR
    from gvl_tpu_torch.training.retriever_train import TrainedTextEmbedder
    from gvl_tpu_torch.utils.checkpoints import resolve_repo_path

    def same(path, seeded) -> bool:
        return path is not None and Path(path).resolve() == Path(seeded).resolve()

    for arm in EVAL_ARMS:
        cfg = FullPipelineRunner(get_model_config(arm), device=dev).preset
        audio, _ = build_audio_stack(cfg.audio, device=dev)
        got = {"ASR": type(audio.asr), "events": type(audio.event_backend),
               "retriever": type(make_embedder(ReasoningCoreConfig(), dev))}
        want = {"ASR": TrainedByteASR, "events": TorchAudioEventDetector,
                "retriever": TrainedTextEmbedder}
        paths = [(resolve_repo_path(cfg.audio.event_checkpoint), ckpts.events),
                 (resolve_repo_path(cfg.audio.asr_checkpoint), ckpts.asr),
                 (resolve_repo_path("outputs/retriever"), ckpts.retriever)]
        if cfg.perception.use_sam:
            got["segmenter"] = type(build_segmenter(cfg, device=dev).backend)
            want["segmenter"] = TorchSegmenterBackend
            paths.append((resolve_repo_path(cfg.perception.sam_checkpoint), ckpts.segmenter))
        if cfg.perception.use_siglip:
            encoder = build_siglip_encoder(cfg, device=dev)
            got["SigLIP encoder"] = type(encoder.backend)
            want["SigLIP encoder"] = TorchSigLIPBackend
            paths.append((resolve_repo_path(cfg.perception.siglip_checkpoint), ckpts.minisiglip))
        off = [(p, seeded) for p, seeded in paths if not same(p, seeded)]
        if got != want or off:
            raise AssertionError(f"eval: {arm}: ladders resolved to {got} on {paths}; want "
                                 f"{want} on the seeded checkpoints")
        ocr = type(create_ocr_pipeline(cfg.perception.ocr_backend, device=dev).engine).__name__
        log("eval", f"{arm}: ladders {({k: v.__name__ for k, v in got.items()})} on the seeded "
            f"checkpoints; OCR ({cfg.perception.ocr_backend!r}, not seeded: it reads the "
            f"repository's outputs/ocr_params.npz) {ocr}; answers "
            f"{resolve_repo_path(cfg.reasoning.llm_checkpoint) or 'the grounded fake'}")


def eval_process(argv: list[str]) -> int:
    """``run_phase1.main(argv)`` as the body of a process of its own (phase
    16 starts it): prints each arm's launches, counted from the building of
    its runner to the next arm's, on a line ``launches {...}`` at the end."""
    from gvl_tpu_torch.eval import phase_runner, run_phase1

    marks, runner_class = [], phase_runner.FullPipelineRunner

    def marked(model_config, **kw):
        marks.append((model_config.name, kernel_launches()))
        return runner_class(model_config, **kw)

    phase_runner.FullPipelineRunner = marked
    rc = run_phase1.main(argv)
    marks.append((None, kernel_launches()))
    print("launches " + json.dumps({arm: {k: after[k] - n for k, n in before.items()}
                                    for (arm, before), (_, after) in zip(marks, marks[1:])}))
    return rc


def run_eval_process(dev, root: Path, out: str) -> dict:
    """``run_phase1`` on the phase's samples as a user runs it, from
    ``root`` (its perception and feature caches, the seeded checkpoints):
    its wall seconds, Stage A per arm (videos newly cached, of, seconds),
    launches per arm, samples.json and aggregates.json."""
    import os

    args = ["--synthetic", "--max-samples", str(EVAL_SAMPLES), "--benchmark", "glitchbench",
            "--configs", *EVAL_ARMS, "--device", dev.type, "--output-dir", str(root / out)]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.eval_process(sys.argv[1:]))", *args],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=EVAL_PROCESS_S)
    wall = time.perf_counter() - t0
    text = done.stdout
    (root / f"{out}.log").write_text(text)
    if done.returncode != 0:
        raise AssertionError(f"eval: run_phase1 ({out}) exited {done.returncode}:\n"
                             f"{text[-4000:]}")
    stage_a = {m[0]: (int(m[1]), int(m[2]), float(m[3])) for m in re.findall(
        r"Stage A \[(\w+)\]: (\d+)/(\d+) videos newly cached in ([\d.]+) s", text)}
    launches = json.loads(re.findall(r"^launches (\{.*\})$", text, re.M)[-1])
    samples, aggregates = (json.loads((root / out / "phase1" / f).read_text())
                           for f in ("samples.json", "aggregates.json"))
    return {"wall": wall, "stage_a": stage_a, "launches": launches, "samples": samples,
            "aggregates": aggregates}


def check_eval_samples(what: str, samples: list) -> None:
    """No sample may have erred or gone unscored."""
    bad = [(s["config_name"], s["sample_id"], s["error"]) for s in samples
           if s["error"] or s["correct"] is None]
    if bad:
        raise AssertionError(f"eval: {what}: samples erred or went unscored: {bad}")


def accuracy(samples: list, arm: str) -> str:
    got = [s["correct"] for s in samples if s["config_name"] == arm]
    return f"{sum(got)}/{len(got)}"


def serve_eval(dev, root: Path, plain: bool) -> tuple[dict, dict]:
    """The phase's samples of each arm through ``PhaseEvaluator`` in this
    process (fresh perception caches, no feature cache), on the kernel path
    or, with ``plain``, every attention through its plain version and the
    QA engine on its plain route.  Returns {arm: samples as dicts} and
    {arm: (Stage A s, Stage B s, launches, speech events, zero-shot
    events)}; on the kernel path each arm's launches are counted from 0 and
    checked against EVAL_ARM_KERNELS."""
    import torch

    from gvl_tpu_torch.eval.loaders import BenchmarkConfig, GlitchBenchLoader
    from gvl_tpu_torch.eval.model_configs import get_model_config
    from gvl_tpu_torch.eval.model_inference import FullPipelineRunner
    from gvl_tpu_torch.eval.perception_cache import PerceptionCache
    from gvl_tpu_torch.eval.phase_runner import PhaseEvaluator
    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine
    from gvl_tpu_torch.nn.layers import plain_attention
    from gvl_tpu_torch.perception import frame_labeler

    tag = "plain" if plain else "kernel"
    evaluator = PhaseEvaluator(f"inprocess_{tag}", list(EVAL_ARMS),
                               cache=PerceptionCache(root / "inprocess" / f"cache_{tag}"),
                               output_dir=str(root / "inprocess" / "results"), device=dev)
    loader = GlitchBenchLoader(BenchmarkConfig(synthetic=True, max_samples=EVAL_SAMPLES))
    samples, parts = {}, {}
    frame_labeler._LABELER_CACHE.clear()   # each path builds its own labeler
    for arm in EVAL_ARMS:
        torch.manual_seed(EVAL_SEED)
        reset_launches()
        with plain_attention() if plain else contextlib.nullcontext():
            runner = FullPipelineRunner(get_model_config(arm), preset=evaluator.preset,
                                        use_cache=False,
                                        perception_cache=evaluator._arm_cache(arm), device=dev)
            t0 = time.perf_counter()
            evaluator.run_perception_caching(loader, runner, arm)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            core = next(iter(runner._processed.values())).loop.reasoning_core
            engine = getattr(core.backend, "engine", None)
            if plain and engine is not None:
                core.backend.engine = Qwen3Engine(engine.config.plain(),
                                                  engine.model.state_dict(),
                                                  eos_token_id=EOS_ID, device=dev)
            try:
                results = [evaluator.evaluate_sample(runner, s, arm).to_dict()
                           for s in loader.load()]
            finally:
                if engine is not None:
                    core.backend.engine = engine
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        launches = (kernel_launches() if plain else
                    served_launches(f"eval {arm}", EVAL_ARM_KERNELS[arm]))
        events = [e for pv in runner._processed.values() for e in pv.timeline.events]
        parts[arm] = (t1 - t0, t2 - t1, launches,
                      sum(e.modality.value == "speech" for e in events),
                      sum((e.entity_id or "").startswith("zs_") for e in events))
        samples[arm] = results
        del runner, core, engine
    return samples, parts


def compare_features(kernel_dir: Path, plain_dir: Path) -> str:
    """extract_features' outputs on the kernel path against the plain path:
    features JSON and context text equal, npz arrays within EVAL_NPZ_SHARE
    of their largest magnitude, the .pt tensors equal to the npz arrays."""
    import numpy as np
    import torch

    names = sorted(p.name for p in kernel_dir.iterdir())
    if names != sorted(p.name for p in plain_dir.iterdir()) or len(names) != 4:
        raise AssertionError(f"eval: extract_features wrote {names}")
    for name in names:
        if name.endswith((".json", ".txt")) and (
                (kernel_dir / name).read_bytes() != (plain_dir / name).read_bytes()):
            raise AssertionError(f"eval: extract_features {name} differs kernel vs plain")
    npz = next(n for n in names if n.endswith(".npz"))
    shares = {}
    with np.load(kernel_dir / npz) as got, np.load(plain_dir / npz) as want:
        arrays = {k: got[k] for k in got.files}
        for key in want.files:
            if got[key].shape != want[key].shape:
                raise AssertionError(f"eval: extract_features {key} shapes differ")
            diff = float(np.abs(got[key] - want[key]).max()) if want[key].size else 0.0
            scale = float(np.abs(want[key]).max()) if want[key].size else 0.0
            shares[key] = diff / scale if scale else (0.0 if diff == 0 else math.inf)
    if max(shares.values()) > EVAL_NPZ_SHARE or not arrays["siglip"].size:
        raise AssertionError(f"eval: extract_features arrays kernel vs plain {shares}")
    blob = torch.load(kernel_dir / npz.replace(".npz", ".pt"), weights_only=True)
    if sorted(blob) != sorted(arrays) or any(
            not np.array_equal(t.numpy(), arrays[k]) for k, t in blob.items()):
        raise AssertionError("eval: extract_features .pt tensors are not the npz arrays")
    return (f"{npz}: " + ", ".join(f"{k} {arrays[k].shape} {shares[k]:.2g}"
                                   for k in sorted(arrays)))


def run_eval(dev, seeded: Path):
    """Phase 16: the evaluation entry points of the port on the two arms it
    serves, as a user runs them, on phase 13's seeded checkpoints
    (``seeded``, labels nudged; moved here): the phase runner as two
    processes, one after the other, then in this process on the kernel path
    and on the plain path, the other phases' and the harness's command
    lines, feature extraction, the projector demo, the smoke test and the
    single-frame runner.  Each served step's launches are counted from 0
    and read right after it; their sum is returned."""
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from gvl_tpu_torch import pipeline
    from gvl_tpu_torch.eval import eval_harness, run_phase3
    from gvl_tpu_torch.eval.loaders import BenchmarkConfig, GlitchBenchLoader
    from gvl_tpu_torch.eval.metrics import AggregateMetrics, SampleMetrics
    from gvl_tpu_torch.eval.model_inference import BenchmarkModelRunner, check_correctness
    from gvl_tpu_torch.nn.layers import plain_attention
    from gvl_tpu_torch.perception import frame_labeler
    from gvl_tpu_torch.perception.encoders import checkpoints_in
    from gvl_tpu_torch.scripts import demo_projector_inference, extract_features, smoke_test

    start = time.perf_counter()
    total = dict.fromkeys(kernel_launches(), 0)

    def add(launches: dict) -> None:
        for name, n in launches.items():
            total[name] += n

    @contextlib.contextmanager
    def counted(step: str, expected: tuple[str, ...] = ()):
        """A served step: its launches from 0, checked, added to the phase's."""
        reset_launches()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        add(served_launches(f"eval {step}", expected))
        log("eval", f"{step}: {time.perf_counter() - t0:.1f} s")

    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_eval_")
    root = Path(workdir.name)
    shutil.move(str(seeded), root / "outputs")
    ckpts = checkpoints_in(root / "outputs")
    let_speech_through(ckpts, ARM_SPEECH_MARGIN)
    # this process's own steps run from a directory of their own (their
    # caches apart from the processes'), the seeded checkpoints linked in
    (root / "inprocess").mkdir()
    (root / "inprocess" / "outputs").symlink_to(root / "outputs", target_is_directory=True)
    here = os.getcwd()
    # the presets' relative checkpoint paths resolve against the working
    # directory first: the seeded files there, the repository's untouched
    os.chdir(root)
    pipeline._LOOP_COMPONENT_CACHE.clear()
    frame_labeler._LABELER_CACHE.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        t0 = time.perf_counter()
        eval_ladders(dev, ckpts)
        log("eval", f"phase 13's seeded checkpoints (seed {GVP_SEED}) in {root}/outputs, "
            f"speech let through in {t0 - start:.1f} s; ladders checked in "
            f"{time.perf_counter() - t0:.1f} s")

        # 1. run_phase1 as a user runs it, twice: the second process rebuilds
        # every clip from the perception cache the first wrote
        first = run_eval_process(dev, root, "first")
        second = run_eval_process(dev, root, "second")
        for what, run in (("first process", first), ("second process", second)):
            check_eval_samples(what, run["samples"])
            peaks = [s["peak_hbm_bytes"] for s in run["samples"]]
            if dev.type == "cuda" and (None in peaks or any(
                    a["hbm_source"] != "allocator_peak" for a in run["aggregates"])):
                raise AssertionError(f"eval: {what}: peak memory {peaks}, sources "
                                     f"{[a['hbm_source'] for a in run['aggregates']]}")
            if sorted(run["stage_a"]) != sorted(EVAL_ARMS) or sorted(run["launches"]) != sorted(
                    EVAL_ARMS):
                raise AssertionError(f"eval: {what}: Stage A of {sorted(run['stage_a'])}, "
                                     f"launches of {sorted(run['launches'])}")
            log("eval", f"run_phase1 {what}: {run['wall']:.1f} s wall; Stage A (new/of, s) "
                f"{run['stage_a']}; accuracy " + ", ".join(
                    f"{arm} {accuracy(run['samples'], arm)}" for arm in EVAL_ARMS)
                + "; Stage B s per sample " + ", ".join(
                    f"{arm} {np.mean([s['total_time_sec'] for s in run['samples'] if s['config_name'] == arm]):.3f}"
                    for arm in EVAL_ARMS)
                + f"; peak {max(a['peak_hbm_gb'] for a in run['aggregates']):.3f} GiB "
                f"({run['aggregates'][0]['hbm_source']})")
        # the first process perceives and answers: every arm's kernels; the
        # second rebuilds from the cache, so only the QA model's answers launch
        for arm in EVAL_ARMS:
            add(served_launches(f"eval run_phase1 first process {arm}", EVAL_ARM_KERNELS[arm],
                                first["launches"][arm]))
            add(served_launches(f"eval run_phase1 second process {arm}",
                                EVAL_ARM_KERNELS[arm] if arm == "qa_lm" else (),
                                second["launches"][arm]))
        if any(new for new, _, _ in second["stage_a"].values()):
            raise AssertionError(f"eval: the second process cached videos: {second['stage_a']}")

        def predictions(samples):
            return {(s["config_name"], s["sample_id"]): s["predicted"] for s in samples}

        if predictions(second["samples"]) != predictions(first["samples"]):
            raise AssertionError(f"eval: the second process predicted otherwise than the "
                                 f"first: {predictions(second['samples'])} against "
                                 f"{predictions(first['samples'])}")

        # 2. the phase's samples in process, kernel path (each arm counted and
        # checked) against plain path (nothing launched)
        os.chdir(root / "inprocess")
        kernel, parts = serve_eval(dev, root, plain=False)
        for arm in EVAL_ARMS:
            add(parts[arm][2])
        with uncounted():
            plain, plain_parts = serve_eval(dev, root, plain=True)
        launched = {(arm, k): n for arm in EVAL_ARMS for k, n in plain_parts[arm][2].items() if n}
        if launched:
            raise AssertionError(f"eval: the plain path launched kernels: {launched}")
        smi = nvidia_smi()
        for arm in EVAL_ARMS:
            check_eval_samples(f"{arm} in process", kernel[arm] + plain[arm])
            agree = sum(a["predicted"] == b["predicted"] for a, b in zip(kernel[arm], plain[arm]))
            same_process = sum(a["predicted"] == predictions(first["samples"])[arm, a["sample_id"]]
                               for a in kernel[arm])
            stage_a, stage_b, launches, speech, zero_shot = parts[arm]
            n = len(kernel[arm])
            log("eval", f"{arm} in process: accuracy kernel {accuracy(kernel[arm], arm)}, plain "
                f"{accuracy(plain[arm], arm)}; answers kernel = plain {agree}/{n}, = the first "
                f"process's {same_process}/{n}; Stage A {stage_a:.2f} s ({stage_a / n:.3f} s per "
                f"sample), Stage B {stage_b:.2f} s ({stage_b / n:.3f} s per sample); plain "
                f"path Stage A {plain_parts[arm][0]:.2f} s, B {plain_parts[arm][1]:.2f} s; "
                "launches per sample " + ", ".join(
                    f"{k} {launches[k] / n:.1f}"
                    for k in ("flash_attention", "decode_attention", "cache_append"))
                + f"; {speech} speech and {zero_shot} zero-shot events; {smi}")
            if agree < n - EVAL_ANSWER_SLACK:
                raise AssertionError(f"eval: {arm}: kernel and plain paths agree on {agree} of "
                                     f"{n} answers")
        if not parts["qa_lm"][3] or not parts["gvp_light"][4]:
            raise AssertionError("eval: no speech events on qa_lm or no zero-shot events on "
                                 "gvp_light: the seeded ladders did not reach their models")

        # 3. run_phase3 (duration filters on) and the harness's mock run
        sample_keys = set(SampleMetrics.__dataclass_fields__)
        aggregate_keys = set(AggregateMetrics.__dataclass_fields__)
        with counted("run_phase3", EVAL_ARM_KERNELS["qa_lm"]):
            if run_phase3.main(["--synthetic", "--max-samples", "2", "--configs", "qa_lm",
                                "--min-duration", "5", "--max-duration", "30", "--device",
                                dev.type, "--output-dir", "phase3_results"]) != 0:
                raise AssertionError("eval: run_phase3 failed")
        phase3 = [json.loads(Path("phase3_results", "phase3", f).read_text())
                  for f in ("samples.json", "aggregates.json")]
        check_eval_samples("run_phase3", phase3[0])
        with counted("eval_harness --mock"):
            if eval_harness.main(["--generate-example", "example.json", "--benchmark",
                                  "example.json", "--mock", "--device", dev.type,
                                  "--output-dir", "harness_results"]) != 0:
                raise AssertionError("eval: eval_harness failed")
        harness = [json.loads(Path("harness_results", "eval_harness", f).read_text())
                   for f in ("samples.json", "aggregates.json")]
        rows = json.loads(Path("example.json").read_text())["samples"]
        if (len(phase3[0]) != 4 or len(phase3[1]) != 2 or len(harness[0]) != len(rows) != 10
                or any(set(s) != sample_keys for s in phase3[0] + harness[0])
                or any(set(a) != aggregate_keys for a in phase3[1] + harness[1])
                or {a["benchmark"] for a in phase3[1]} != {"longvideobench", "mlvu"}):
            raise AssertionError(f"eval: run_phase3 / eval_harness JSON layout: {phase3}, "
                                 f"{harness}")
        log("eval", f"run_phase3 ({len(phase3[0])} samples, accuracy "
            f"{accuracy(phase3[0], 'qa_lm')}) and eval_harness --mock ({len(harness[0])} "
            f"samples, accuracy {harness[1][0]['accuracy']:.3f}): exit 0, layouts as JAX's")

        # 4. extract_features, kernel path against plain path; the projector demo
        argv = ["--video", EVAL_CLIP, "--device", dev.type, "--output-dir"]
        with counted("extract_features", ("flash_attention",)):
            if extract_features.main(argv + ["features_kernel"]) != 0:
                raise AssertionError("eval: extract_features failed")
        with uncounted(), plain_attention():
            reset_launches()
            if extract_features.main(argv + ["features_plain"]) != 0:
                raise AssertionError("eval: extract_features failed on the plain path")
            launched = {k: n for k, n in kernel_launches().items() if n}
        if launched:
            raise AssertionError(f"eval: extract_features' plain path launched {launched}")
        compared = compare_features(Path("features_kernel"), Path("features_plain"))
        npz = next(Path("features_kernel").glob("*.npz"))
        out = io.StringIO()
        with counted("demo_projector_inference"), contextlib.redirect_stdout(out):
            rc = demo_projector_inference.main(["--embeddings", str(npz), "--device", dev.type])
        response = out.getvalue().split("\n", 2)[-1].strip()
        if rc != 0 or not response or response == "[no response]":
            raise AssertionError(f"eval: projector demo exited {rc}: {out.getvalue()!r}")
        log("eval", f"extract_features kernel = plain path ({compared}); projector demo: "
            f"{response.splitlines()[0][:80]!r}")

        # 5. the smoke test on the card
        out = io.StringIO()
        with counted("smoke_test"), contextlib.redirect_stdout(out):
            rc = smoke_test.main(["--device", dev.type])
        if rc != 0 or out.getvalue().count("PASS  ") != 7:
            raise AssertionError(f"eval: smoke_test exited {rc}:\n{out.getvalue()}")
        log("eval", f"smoke_test --device {dev.type}: 7/7 checks pass")

        # 6. the single-frame runner on video samples (the card has no Pillow)
        with counted("single-frame runner"):
            runner = BenchmarkModelRunner(preset="light", device=dev)
            core = runner._get_core()
            calls, reason = [], core.reason

            def recorded(query, **kw):
                response = reason(query, **kw)
                calls.append((query, response))
                return response

            core.reason = recorded
            single = GlitchBenchLoader(BenchmarkConfig(synthetic=True,
                                                       max_samples=EVAL_SINGLE_FRAME)).load()
            answers = [runner.run_inference(s)[0] for s in single]
        frames = [runner._load_frame(s) is not None for s in single]
        if (not all(frames) or len(calls) != len(single) or not all(answers)
                or any("[Visual Analysis]" not in q or "Visual analysis unavailable" in q
                       or not r for q, r in calls)):
            raise AssertionError(f"eval: single-frame runner: frames {frames}, answers "
                                 f"{answers}, calls {calls}")
        correct = sum(check_correctness(a, s) for a, s in zip(answers, single))
        log("eval", f"single-frame runner: {len(single)} frames decoded, answers {answers} "
            f"({correct}/{len(single)} correct), {runner.total_inference_time:.2f} s")
        del runner, core

        elapsed = time.perf_counter() - start
        log("eval", f"phase 16 in {elapsed:.1f} s (budget {EVAL_BUDGET_S} s); launches "
            f"{total}; in-process peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} "
            f"GiB; {nvidia_smi()}")
        if elapsed > EVAL_BUDGET_S:
            raise AssertionError(f"eval: phase 16 took {elapsed:.1f} s, over its "
                                 f"{EVAL_BUDGET_S} s budget")
    finally:
        os.chdir(here)
        pipeline._LOOP_COMPONENT_CACHE.clear()
        frame_labeler._LABELER_CACHE.clear()
        workdir.cleanup()
        torch.cuda.empty_cache()
    return total


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import tempfile

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
    torch.cuda.empty_cache()
    served.append(run_arm(dev))
    torch.cuda.empty_cache()
    seeded = tempfile.TemporaryDirectory(prefix="chip_smoke_seeded_")
    served.append(run_gvp(dev, keep=Path(seeded.name, "outputs")))
    torch.cuda.empty_cache()
    served.append(run_slice(dev))
    torch.cuda.empty_cache()
    served.append(run_vl(dev))
    torch.cuda.empty_cache()
    served.append(run_eval(dev, seeded=Path(seeded.name, "outputs")))
    seeded.cleanup()
    launches = {name: sum(run.get(name, 0) for run in served) for name in served[0]}
    log("launches", f"served paths (phases 3-16): {launches}")
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
