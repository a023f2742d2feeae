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
   attention and its MAP head, at Qwen3-VL's tower, the perception
   encoders' shapes and the HF rungs' (wav2vec2-large, Whisper-base's
   encoder, VideoMAE-base, SigLIP so400m's text tower; ``lines`` of row 1,
   device ms from the profiler where measured), and the int8 product
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
    samples; within ``EVAL_BUDGET_S``;
17. the HF perception rungs at the JAX package's default geometries
    (all-MiniLM-L6-v2, wav2vec2-large, whisper-base, videomae-base, SigLIP
    so400m vision and text, sam-vit-base) on seeded f32 weights drawn in the
    HF checkpoint layout (``gvl_tpu_torch.models.hf_layouts``) and put
    through the port's ``convert_hf_*``, each built as its rung builds it
    (crc32-seeded token ids where the rung would call a tokenizer) and
    served once with every kernel's launches counted from 0 and held to the
    count the code implies: MiniLM's embeddings of 64 texts (no kernel;
    card against the CPU), the wav2vec2 chunk embedder on 2 chunks of 10 s,
    Whisper's greedy decode of one 30 s window (16 steps), VideoMAE on 2
    clips of 16 frames, ``SigLIPSemanticEncoder.from_tower_state``'s fused
    W8A8 tower and the composite's bf16 'cls' backend on 8 frames at 384,
    the text tower on 8 prompts, and the open-vocab composite (SAM
    point-grid proposals, 4 x 4 points on 2 frames, named by the SigLIP
    pair); each against its plain path (encoder outputs within 1e-4 of
    their largest magnitude, pooled cosine >= 0.9995, tokens and detections
    equal); wall ms per model, allocator peak, within ``HF_BUDGET_S``;
18. training the served decoder (``gvl_tpu_torch.training``): ``train_qa_lm``
    warm-started from ``outputs/qa_lm`` (10 layers, hidden 640, 10/5 heads of
    64, intermediate 2560) with phase B's settings (batch 16 at max_len 4096,
    every weight cast to bf16 in the loss, each layer rematerialised, lr
    1.5e-4, pipeline 0.3, short 0.15, lookup 0.1) for 6 steps on one fixed
    batch: ms per step, token positions per second, device ms, busy share
    and B1's share (profiler, steps 3 and 4), allocator peak, B1 launches per
    step (30: forward, remat's recompute and the blockwise backward's delta
    recompute, per layer), the loss falling and finite; one step's forward,
    backward and optimizer timed apart (events); 3 steps on 2 rows of that
    batch along the f32 plain path's trajectory, the kernel path, the plain
    path and the f32 path each taking its gradients at the same parameters:
    every gradient and the loss within 1.5x the plain path's error of f32
    plus ``GRAD_FLOOR``; ``save_qa_lm`` and ``load_qa_lm`` bit-equal, then 8
    held-out answers of the saved model (B1, B2, B3); ``train_qa_lm_lora``
    (rank 32, batch 16 x 2560, f32) for 4 steps: 20 B1 launches a step,
    frozen tensors bit-equal, every ``lora_b`` moved, the adapter merged
    through ``create_reasoning_core(lora_path=)`` answering 8 samples as its
    plain path does; ``ProjectorTrainer``'s generative objective over the
    frozen QA model on seeded embeddings (10 B1 launches a step, the LLM
    bit-equal, ``projector_weights.pt`` read back through
    ``ProjectorBank``); ``python -m gvl_tpu_torch.scripts.train_qa_lm
    --geometry v5`` and ``finetune_lora --data`` as two processes run
    together (exit 0, their files); within ``TRAIN_BUDGET_S``.  Phase 2
    also times B1 at the training shape (row 1r);
19. the perception trainers (``run_perception_train``), each at its default
    config and batch with weights drawn by Flax's laws (seed ``PT_SEED``):
    the segmenter (``SamConfig()``), the OCR recognizer and detector
    (``OCRModelConfig(rec_arch="v2")``, their steps on seeded arrays: the
    card's machine has no Pillow to render text), the audio-event net, the
    byte ASR (``asr_config()``, rendered in its spawned pool), the SigLIP
    text tower's corpus pretraining (``PT_PRETRAIN_STEPS``) and the
    mini-SigLIP pair, the retriever's tower, the VideoMAE clip classifier and
    HiCo's pool (1408 wide): at the start, the kernel path's loss and every
    gradient within ``PT_GRAD_REL`` of the plain path's (f32, TF32 off) with
    B1 launched as implied on the kernel path and never on the plain;
    ``PT_FIXED_STEPS`` steps of Adam on the first batch, the loss falling;
    ``PT_STEPS`` trainer steps with B1's launches per step as implied, wall
    ms per step, device ms, busy share and B1's share (profiler, every step
    but the first), the plain attention backward's share (events), allocator
    peak, finite losses; the trained weights saved, reloaded
    bit-equal through the serving classes and served once on the kernel
    path; the scripts (``--steps 2``, all but ``train_ocr``) as processes,
    at most ``PT_SCRIPTS_AT_ONCE`` at a time, each exiting 0 with its file;
    within ``PT_BUDGET_S``.  Phase 2 also times B1 at the two largest of
    those trainers' shapes (rows 1s, 1t);
20. multi-device on one card (``gvl_tpu_torch.parallel``): (a) an NCCL world
    of one rank (a ``file://`` store), the 8B geometry at depth 4 in bf16
    through ``Qwen3Engine(mesh=)`` at a 1 x 1 mesh, prefill 128 and 16
    greedy steps, logits and tokens bit-equal to the unsharded engine's;
    (b) a gloo world of two processes sharing ``cuda:0`` (``mesh_process``;
    every tensor on the card, the backend chosen by the layout): TP 2 at
    the 8B geometry in f32 (tokens equal to the unsharded engine's), bf16
    (logits within the unsharded bf16 run's own distance from f32), int8
    and ``scan_layers`` (tokens equal), B1 4 per prefill and B2 = B3 (B4 =
    B5) 4 per step on each rank at 16 query and 4 KV heads; the trained QA
    model through ``ContinuousBatchingEngine(mesh=)`` at 2 x 1 and 1 x 2 on
    8 of phase 5's prompts and 4 slots, answers equal to the unsharded
    engine's; ring attention at [1, 8, 8192, 128] bf16, causal and not,
    output and gradients against f32 full attention beside the plain bf16
    path and B1; the segmenter (phase 11's weights) and the fused W8A8 so400m
    tower, padded and packed heads (phase 9's), on 8 frames over data 2
    against one rank; and ``torchrun --nproc-per-node 2 -m
    gvl_tpu_torch.scripts.deploy_api --tp 2`` on the QA model answering 4
    concurrent ``POST /generate`` as the unsharded ``generate_many``, then
    stopped by SIGTERM to its serving rank (both exit 0); per rank decode ms
    per step against the unsharded step, collective ms, allocator peak;
    within ``MESH_BUDGET_S``.  Phase 0 also notes which gloo collectives
    take CUDA tensors in this PyTorch;
21. the rest of the public surface (``run_surface``): the decoder-family
    ``nn.TransformerStack`` (RMSNorm, SwiGLU, causal GQA, rope base 1e6,
    qk-norm, no biases) at the 8B layer geometry, depth 2, bf16, one
    sequence of 2048 (``SURFACE_GEOMETRY``), kernel path against the plain
    path (``nn.layers.plain_attention``) and both against an f32 plain
    evaluation of the same weights, forward and forward + backward: the
    output, the input's gradient and the parameters' gradients within
    twice the plain bf16 path's relative L2 (floor 2^-8, phase 20's rule),
    B1 2 a forward and 2 more a backward (the blockwise backward's delta),
    none on the plain path; a cross-attention call and a ``kv_len``-masked
    block at small shapes; the fused so400m tower with ``int8_attention``
    (phase 9's seeded weights, 8 frames at 384 px) against its plain path,
    pooled cosine >= ``COS_KERNEL_PLAIN``, B9 27 a forward in its
    int8_scores mode, beside the tower without it (cosine and images/s
    recorded); ``encode_with_context`` equal to its two region calls;
    ``stage_scope`` by name in a ``torch.profiler`` trace and
    ``device_memory_stats`` nonzero; within ``SURFACE_BUDGET_S``.  Phase 2
    also times B1 at the stack's shape (row 1u) and B9 in its int8_scores
    mode (row 9a: events, and device ms of its quantize pre-pass and its
    ``wgmma`` body apart), after ``cuobjdump`` shows that body on IGMMA.

Kernel launch counts are zeroed just before each served run (the kernel
path of phases 3 to 21) and read just after it; each run must have launched
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
# the kernels of B9's int8_scores mode, by name in a profile: the quantize
# pre-pass and the wgmma body (csrc/encoder_attention_int8.cu)
INT8_PREPASS, INT8_BODY = ("quantize_slabs_kernel",), ("encoder_attention_int8_kernel",)
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
# phase 17: the HF perception rungs at the JAX package's default (published)
# geometries, seeded f32 weights drawn in the HF checkpoint layout
# (gvl_tpu_torch.models.hf_layouts) and converted by the port's convert_hf_*
HF_SEED = 17
HF_TEXTS, HF_CPU_TEXTS = 64, 16        # MiniLM: served texts; of them, held to the CPU
HF_W2V_CHUNKS, HF_W2V_SECONDS = 2, 10  # wav2vec2-large chunks of 10 s at 16 kHz
HF_WHISPER_STEPS = 16                  # Whisper-base: greedy steps on one 30 s window
HF_CLIPS = 2                           # VideoMAE-base clips of 16 x 224 x 224
HF_FRAMES, HF_PROMPTS = 8, 8           # SigLIP so400m: frames at 384, text prompts
HF_SAM_FRAMES, HF_SAM_GRID = 2, 4      # SAM ViT-base at 1024: frames, point grid side
HF_SHARE = 1e-4         # encoder outputs, kernel vs plain path: share of the largest |value|
HF_CONF_TOL = 1e-4      # the composite's detection scores (cosines), kernel vs plain path
HF_BUDGET_S = 120
# phase 18: training the served decoder: outputs/qa_lm (the 62M geometry)
# warm-started with phase B's settings (scripts/run_qa_lm_phaseB.sh: lr
# 1.5e-4, pipeline 0.3, short 0.15, lookup 0.1, its family weights), batch
# 16 at max_len 4096, every weight cast to bf16 in the loss, each layer
# rematerialised; one fixed batch (pool_size = batch), so the loss must fall
TRAIN_SEED = 18
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LEN = 6, 16, 4096
TRAIN_PHASE_B = dict(learning_rate=1.5e-4, pipeline_frac=0.3, short_mix=0.15,
                     lookup_frac=0.1, family_weights=(0.15, 0.15, 0.2, 0.2, 0.3, 0.0))
TRAIN_PROFILED = (3, 5)     # the profiler's window: steps 3 and 4
# B1 launches per step implied by the code: at seq 4096 with remat the
# forward, remat's recompute and the blockwise backward's delta recompute,
# each once a layer; at 2560 without remat (LoRA) the forward and delta;
# at 33 (projector: one projected row and 32 target bytes) the forward alone
B1_PER_LAYER = {"remat 4096": 3, "lora 2560": 2, "projector 33": 1}
# gradients (relative L2 error per parameter tensor) and the loss against
# an f32 evaluation of the plain path, on 2 rows of a batch over 3 steps of
# the f32 path's trajectory (the three paths at the same parameters each
# step): the kernel path may stray by 1.5x the bf16 plain path's error plus this
GRAD_ROWS, GRAD_STEPS, GRAD_FLOOR = 2, 3, 1e-3
TRAIN_EVAL_SAMPLES = 8
LORA_TRAIN_STEPS = 4
PROJ_ROWS, PROJ_BATCH = 16, 8   # seeded embeddings per modality, batch
PROJ_F16_REL = 5e-3         # projections after the f16 round trip of projector_weights.pt
TRAIN_PROCESS_S = 150       # each of the phase's two processes (run together)
TRAIN_BUDGET_S = 180
# phase 19: each perception trainer at its default config for PT_STEPS steps
# (the profiler over every step but the first), the SigLIP text tower's pretraining for
# PT_PRETRAIN_STEPS; the kernel path's loss and gradients against the plain
# path's at the start (relative L2, each gradient's norm floored at
# PT_GRAD_FLOOR of the whole gradient's: an attention's key bias has a
# gradient that is zero but for rounding); the scripts as processes
PT_SEED = 19
PT_STEPS, PT_PRETRAIN_STEPS = 3, 2
# steps of Adam on one fixed batch over which the loss must fall: from the
# drawn start the clip classifier's loss rises for its first 3-5 steps at
# lr 3e-4 (its unnormalised clip embedding, norm ~45), then falls
PT_FIXED_STEPS = 8
PT_GRAD_REL, PT_GRAD_FLOOR = 1e-4, 1e-3
PT_SCRIPT_S = 150
PT_SCRIPTS_AT_ONCE = 4
PT_BUDGET_S = 180

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

    # the HF perception rungs' attention (phase 17), f32 as their checkpoints
    # load: wav2vec2-large on one 10 s chunk, Whisper-base's encoder on one
    # 30 s window, VideoMAE-base on 2 clips, SigLIP so400m's text tower on 8
    # prompts (head 72 padded to 80 by the wrapper)
    for shape, b, h, s_len, d in (
            ("wav2vec2-large: q/k/v [1,16,499,64] f32", 1, 16, 499, 64),
            ("Whisper-base encoder: q/k/v [1,8,1500,64] f32", 1, 8, 1500, 64),
            ("VideoMAE-base: q/k/v [2,12,1568,64] f32", 2, 12, 1568, 64),
            ("SigLIP so400m text tower: q/k/v [8,16,64,72] f32 (head padded to 80)",
             8, 16, 64, 72)):
        qt, kt, vt = (randn(b, h, s_len, d) for _ in range(3))
        err = assert_close(f"flash_attention {shape}", flash_attention(qt, kt, vt),
                           attention_reference(qt, kt, vt), F32_TOL)
        line_bound = bound_ms(4 * qt.nbytes, 4.0 * b * h * d * s_len * s_len, torch.bfloat16)
        flash["lines"].append(dict(
            name="flash_attention", shape=shape, max_abs_err=err,
            ms=time_ms(lambda: flash_attention(qt, kt, vt), 50),
            device_ms=kernel_device_ms(lambda: flash_attention(qt, kt, vt),
                                       ("flash_attention",)),
            plain_ms=time_ms(lambda: attention_reference(qt, kt, vt), 10),
            bound_ms=line_bound[0], bound_by=line_bound[1], bound_peak=line_bound[2],
            library="SDPA, f32",
            library_ms=time_ms(lambda: library_flash(qt, kt, vt, False), 50)))

    # the QA model's training step (phase 18, PERF.md row 1r): 16 rows of
    # 4096 bytes with every weight cast to bf16, causal, 10 heads over 5 KV
    # heads; the plain version holds f32 scores of every pair (~11 GB)
    shape = "QA training (phase 18): q [16,10,4096,64], k/v [16,5,4096,64] bf16, causal"
    qt = randn(16, 10, 4096, 64, dtype=torch.bfloat16)
    kt, vt = (randn(16, 5, 4096, 64, dtype=torch.bfloat16) for _ in range(2))
    err = assert_close(f"flash_attention {shape}", flash_attention(qt, kt, vt, causal=True),
                       attention_reference(qt, kt, vt, causal=True), BF16_TOL)
    line_bound = bound_ms(sum(t.nbytes for t in (qt, kt, vt)) + qt.nbytes,
                          4.0 * 16 * 10 * 64 * attention_pairs(4096, 4096, True, None),
                          torch.bfloat16)
    flash["lines"].append(dict(
        name="flash_attention", shape=shape, max_abs_err=err,
        ms=time_ms(lambda: flash_attention(qt, kt, vt, causal=True), 10),
        device_ms=kernel_device_ms(lambda: flash_attention(qt, kt, vt, causal=True),
                                   ("flash_attention",), 10),
        plain_ms=time_ms(lambda: attention_reference(qt, kt, vt, causal=True), 3),
        bound_ms=line_bound[0], bound_by=line_bound[1], bound_peak=line_bound[2],
        library="SDPA, bf16",
        library_ms=time_ms(lambda: library_flash(qt, kt, vt, True), 10)))
    del qt, kt, vt
    torch.cuda.empty_cache()

    # the decoder-family nn.TransformerStack at the 8B layer geometry (phase
    # 21, PERF.md row 1u): one sequence of 2048, GQA 32/8, causal, bf16
    shape = "nn decoder stack (phase 21): q [1,32,2048,128], k/v [1,8,2048,128] bf16, causal"
    qt = randn(1, 32, 2048, 128, dtype=torch.bfloat16)
    kt, vt = (randn(1, 8, 2048, 128, dtype=torch.bfloat16) for _ in range(2))
    err = assert_close(f"flash_attention {shape}", flash_attention(qt, kt, vt, causal=True),
                       attention_reference(qt, kt, vt, causal=True), BF16_TOL)
    line_bound = bound_ms(sum(t.nbytes for t in (qt, kt, vt)) + qt.nbytes,
                          4.0 * 32 * 128 * attention_pairs(2048, 2048, True, None),
                          torch.bfloat16)
    flash["lines"].append(dict(
        name="flash_attention", shape=shape, max_abs_err=err,
        ms=time_ms(lambda: flash_attention(qt, kt, vt, causal=True), 50),
        device_ms=kernel_device_ms(lambda: flash_attention(qt, kt, vt, causal=True),
                                   ("flash_attention",)),
        plain_ms=time_ms(lambda: attention_reference(qt, kt, vt, causal=True), 10),
        bound_ms=line_bound[0], bound_by=line_bound[1], bound_peak=line_bound[2],
        library="SDPA, bf16",
        library_ms=time_ms(lambda: library_flash(qt, kt, vt, True), 50)))
    del qt, kt, vt

    # the two largest attention shapes of the perception trainers (phase 19,
    # PERF.md rows 1s and 1t), f32 as they train: VideoMAE's at its batch of
    # 16 clips and the byte ASR's encoder at its batch of 24 windows
    for shape, b, h, s_len, d in (
            ("VideoMAE training (phase 19): q/k/v [16,4,392,64] f32", 16, 4, 392, 64),
            ("byte ASR training (phase 19), encoder: q/k/v [24,4,300,64] f32", 24, 4, 300, 64)):
        qt, kt, vt = (randn(b, h, s_len, d) for _ in range(3))
        err = assert_close(f"flash_attention {shape}", flash_attention(qt, kt, vt),
                           attention_reference(qt, kt, vt), F32_TOL)
        line_bound = bound_ms(4 * qt.nbytes, 4.0 * b * h * d * s_len * s_len, torch.bfloat16)
        flash["lines"].append(dict(
            name="flash_attention", shape=shape, max_abs_err=err,
            ms=time_ms(lambda: flash_attention(qt, kt, vt), 50),
            device_ms=kernel_device_ms(lambda: flash_attention(qt, kt, vt),
                                       ("flash_attention",)),
            plain_ms=time_ms(lambda: attention_reference(qt, kt, vt), 10),
            bound_ms=line_bound[0], bound_by=line_bound[1], bound_peak=line_bound[2],
            library="SDPA, f32",
            library_ms=time_ms(lambda: library_flash(qt, kt, vt, False), 50)))
    del qt, kt, vt

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
    # B9 in its int8_scores mode at the same frames (phase 21's tower with
    # int8_attention, PERF.md row 9a): a quantize pre-pass, then both
    # products on wgmma s8 fed by TMA (csrc/encoder_attention_int8.cu)
    from gvl_tpu_torch.device_times import kernel_device_ms

    kw8 = dict(kw, dh_pad=128, out_scale_inv=40.0, int8_scores=True)
    bnd = bound_ms(qkv.nbytes + qkv.nbytes // 6, 4.0 * 128 * pairs, torch.int8)
    b9 = next(row for row in rows if row["name"] == "attention_fused_qkv")
    int8_call = lambda: qm.attention_fused_qkv(qkv, **kw8)   # noqa: E731
    pre, body = kernel_device_ms(int8_call, INT8_PREPASS), kernel_device_ms(int8_call, INT8_BODY)
    b9["lines"] = [dict(
        name="attention_fused_qkv", route="cuda",
        source="gvl_tpu_torch/csrc/encoder_attention_int8.cu", max_abs_err=att[("fused", "frames")],
        shape="so400m layer, batch 8, int8_scores: bf16 [5888,3x16x128] -> int8",
        ms=time_ms(int8_call), device_ms=kernel_device_ms(int8_call, INT8_PREPASS + INT8_BODY),
        prepass_device_ms=pre, body_device_ms=body,
        plain_ms=time_ms(lambda: qm.attention_fused_qkv_reference(qkv, **kw8), 5),
        bound_ms=bnd[0], bound_by=bnd[1], bound_peak=bnd[2], library="SDPA, bf16",
        library_ms=time_ms(lambda: library_encoder_attention(qkv, 8, 736, 16, 128, mask)))]
    line = b9["lines"][0]
    log("kernels", f"attention_fused_qkv int8_scores at so400m frames: kernel "
        f"{line['ms']:.4f} ms (device {line['device_ms']}: pre-pass {pre}, body {body}), "
        f"plain {line['plain_ms']:.4f} ms, SDPA {line['library_ms']:.4f} ms, bound "
        f"{bnd[0]:.5f} ms ({bnd[1]})")
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
    """The built library's w8a8_matmul kernels and int8_scores attention
    bodies issue warpgroup int8 products (IGMMA in the SASS) and no
    mma.sync ones (IMMA), read with cuobjdump where the toolkit has it."""
    from gvl_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        log("kernels", f"SASS of the wgmma kernels not checked: no {tool}")
        return
    sass = subprocess.run([str(tool), "--dump-sass", str(_build.build().path)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    for name in ("w8a8_matmul_kernel", "encoder_attention_int8_kernel"):
        kernels = [part for part in sass.split("Function : ")[1:]
                   if name in part.split("\n", 1)[0]]
        igmma = [part.count("IGMMA") for part in kernels]
        imma = sum(len(re.findall(r"\bIMMA\b", part)) for part in kernels)
        log("kernels", f"SASS: {len(kernels)} {name}s, IGMMA per kernel "
            f"{sorted(set(igmma))}, IMMA {imma}")
        if not kernels or min(igmma) == 0 or imma:
            raise AssertionError(f"{name}: the built kernels are not on wgmma")


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


def fused_pooled(backend, pixels, **kw):
    """Pooled embeddings of the backend's fused tree on normalised pixels
    (``kw``: ``siglip_fused_apply``'s ``int8_attention``, ``kernels``)."""
    import torch

    from gvl_tpu_torch.models.siglip_fused import siglip_fused_apply

    with torch.inference_mode():
        out = siglip_fused_apply(backend.fused, pixels, backend.config, pool=False, **kw)
    torch.cuda.synchronize()
    return backend.pooled(out)


def plain_pooled(backend, batch):
    """The plain path of the backend's fused tree on the same batch."""
    import torch

    return fused_pooled(backend, backend.normalize(batch, torch.bfloat16), kernels=False)


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


# --------------------------------------------------------------------------
# phase 17: the HF perception rungs
# --------------------------------------------------------------------------

def seeded_ids(text: str, length: int, vocab: int, low: int = 1000) -> "np.ndarray":
    """Token ids a text always gets here (crc32-seeded), where the card has
    no tokenizer: ``length`` ids in [low, vocab)."""
    import zlib

    import numpy as np

    rng = np.random.default_rng(zlib.crc32(text.encode()))
    return rng.integers(low, vocab, length)


class SeededWhisperTokenizer:
    """What ``WhisperTorchASR`` asks of ``transformers.WhisperTokenizer``:
    whisper-base's prompt ids, and token ids joined as text."""

    PROMPT = {"<|startoftranscript|>": 50258, "<|en|>": 50259, "<|transcribe|>": 50359,
              "<|notimestamps|>": 50363}

    def convert_tokens_to_ids(self, tokens):
        return [self.PROMPT[t] for t in tokens]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def decode_steps(tokens, prompt_len: int, eos: int) -> int:
    """How many decoder steps ``greedy_decode_cached`` ran for one stream:
    up to the first generated EOS, else every position but the last."""
    row = tokens[0].tolist()
    ends = [j for j in range(prompt_len, len(row)) if row[j] == eos]
    return ends[0] if ends else len(row) - 1


def run_hf(dev):
    """Phase 17: each HF rung's model at its published geometry, from seeded
    weights in the HF layout through the port's converter, served once
    through its entry point with every kernel's launches counted from 0 and
    held to the count the code implies, then against its plain path."""
    import copy

    import numpy as np
    import torch

    from gvl_tpu_torch.audio.mel import log_mel_spectrogram
    from gvl_tpu_torch.audio.processor import Wav2Vec2TorchEmbedder, WhisperTorchASR
    from gvl_tpu_torch.models import hf_layouts as L
    from gvl_tpu_torch.models import minilm, sam_vit, videomae, wav2vec2, whisper
    from gvl_tpu_torch.models import siglip
    from gvl_tpu_torch.nn.layers import plain_attention
    from gvl_tpu_torch.perception import encoders as E
    from gvl_tpu_torch.perception.open_vocab import OpenVocabSamBackend
    from gvl_tpu_torch.perception.semantic import (
        NaFlexConfig,
        SigLIPSemanticEncoder,
        TorchSigLIPBackend,
    )
    from gvl_tpu_torch.temporal.clip_encoder import TorchVideoMAEClipEncoder

    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(HF_SEED)
    rng = np.random.default_rng(HF_SEED)
    total, walls = {}, {}

    def draw(layout):
        return L.random_state(layout, gen, dev)

    def served(name: str, fn, want):
        """``fn()`` once with the launches counted from 0; ``want`` (a dict,
        or a function of the result giving one) is every kernel's count the
        code implies, the others 0."""
        with uncounted():
            fn()                         # lazy kernel loads, allocator growth
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = 1e3 * (time.perf_counter() - t0)
        counts = kernel_launches()
        expected = want(out) if callable(want) else want
        wrong = {k: (v, expected.get(k, 0)) for k, v in counts.items()
                 if v != expected.get(k, 0)}
        log("hf", f"{name}: {walls[name]:.1f} ms wall (host clock); launches "
            f"{ {k: v for k, v in counts.items() if v} } (implied {expected})")
        if wrong:
            raise AssertionError(f"hf: {name}: launches (counted, implied) {wrong}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out

    def share(what: str, got, want) -> float:
        got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"hf: {what}: {tuple(got.shape)} vs {tuple(want.shape)} "
                                 "or not finite")
        scale = want.abs().max().item()
        return check_share("hf", f"{what}: max abs err per max |value| {scale:.3g}",
                           (got - want.to(got.device)).abs().max().item() / scale, HF_SHARE)

    # 1. MiniLM (all-MiniLM-L6-v2): plain attention, as in JAX; card vs CPU
    cfg = minilm.MiniLMConfig()
    model = minilm.load_minilm(cfg, minilm.convert_hf_bert(draw(L.bert_layout(cfg)), cfg), dev)

    def bert_tokenize(texts, max_len):
        ids = np.zeros((len(texts), max_len), np.int64)
        mask = np.zeros_like(ids)
        for i, text in enumerate(texts):
            n = min(max_len, 4 + 2 * len(text.split()))
            ids[i, :n], mask[i, :n] = seeded_ids(text, n, cfg.vocab_size), 1
        return ids, mask

    texts = E.retrieval_texts(HF_TEXTS, HF_SEED)[1]
    encoder = minilm.MiniLMSentenceEncoder(model, bert_tokenize)
    got = served("MiniLM", lambda: encoder.encode(texts), {})
    cpu = minilm.MiniLMSentenceEncoder(copy.deepcopy(model).cpu(), bert_tokenize)
    share(f"MiniLM ({HF_CPU_TEXTS} of {HF_TEXTS} texts): card vs CPU", got[:HF_CPU_TEXTS],
          cpu.encode(texts[:HF_CPU_TEXTS]))
    del model, encoder, cpu

    # 2. wav2vec2-large (the preset's wav2vec_model): 24 layers, B1 in each
    cfg = wav2vec2.Wav2Vec2Config.large()
    w2v = wav2vec2.load_wav2vec2(
        cfg, wav2vec2.convert_hf_wav2vec2(draw(L.wav2vec2_layout(cfg)), cfg), dev)
    embedder = Wav2Vec2TorchEmbedder(w2v, chunk_seconds=HF_W2V_SECONDS)
    audio = E.soundtrack(HF_W2V_CHUNKS * HF_W2V_SECONDS, seed=HF_SEED)
    chunks = audio.reshape(HF_W2V_CHUNKS, -1)
    got = served("wav2vec2-large", lambda: np.stack([embedder(c, 16000) for c in chunks]),
                 {"flash_attention": cfg.num_layers * HF_W2V_CHUNKS})
    with uncounted(), torch.inference_mode():
        wav = torch.from_numpy(chunks).to(dev)
        states = w2v(wav)["last_hidden_state"]
        with plain_attention():
            want_states = w2v(wav)["last_hidden_state"]
            want = np.stack([embedder(c, 16000) for c in chunks])
    log("hf", f"wav2vec2-large: {tuple(states.shape)} states of {HF_W2V_CHUNKS} chunks")
    share("wav2vec2-large: encoder states, kernel vs plain path", states, want_states)
    check_cosine("hf", "wav2vec2-large chunk embeddings: kernel vs plain path", got, want,
                 COS_KERNEL_PLAIN)
    del w2v, embedder, states, want_states

    # 3. Whisper-base: one 30 s window, the cached greedy decode
    cfg = whisper.WhisperConfig.base()
    model = whisper.load_whisper(
        cfg, whisper.convert_hf_whisper(draw(L.whisper_layout(cfg)), cfg), dev)
    asr = WhisperTorchASR(model, SeededWhisperTokenizer(), max_new_tokens=HF_WHISPER_STEPS)
    speech = E.soundtrack(30, seed=HF_SEED + 1)
    prompt_len = asr._prompt.shape[1]
    tokens = served("Whisper-base", lambda: asr.decode(speech), lambda out: {
        "flash_attention": cfg.encoder_layers
        + cfg.decoder_layers * decode_steps(out, prompt_len, cfg.eos_token_id)})
    with uncounted(), torch.inference_mode():
        text, conf = asr(speech, 16000)
        mel = log_mel_spectrogram(torch.from_numpy(speech).to(dev))[None]
        states = model.encoder(mel)
        with plain_attention():
            want_states = model.encoder(mel)
            want_tokens = asr.decode(speech)
    share("Whisper-base: encoder states [1,1500,512], kernel vs plain path", states,
          want_states)
    if not torch.equal(tokens, want_tokens):
        raise AssertionError(f"hf: Whisper tokens differ: kernel {tokens.tolist()}, plain "
                             f"{want_tokens.tolist()}")
    log("hf", f"Whisper-base: greedy tokens equal on both paths "
        f"({decode_steps(tokens, prompt_len, cfg.eos_token_id)} decoder steps); transcript "
        f"{len(text.split())} ids, confidence {conf}")
    del model, asr, states, want_states

    # 4. VideoMAE-base: 2 clips of 16 frames in one forward
    cfg = videomae.VideoMAEConfig.base()
    clip_encoder = TorchVideoMAEClipEncoder(videomae.load_videomae(
        cfg, videomae.convert_hf_videomae(draw(L.videomae_layout(cfg)), cfg), dev))
    clips = [np.stack(E.gameplay_frames(cfg.num_frames, seed=HF_SEED + i))
             for i in range(HF_CLIPS)]
    got = served("VideoMAE-base", lambda: clip_encoder.encode_clips(clips),
                 {"flash_attention": cfg.num_layers})
    with uncounted(), plain_attention():
        want = clip_encoder.encode_clips(clips)
    share(f"VideoMAE-base ({HF_CLIPS} clips): clip vectors, kernel vs plain path", got, want)
    check_cosine("hf", "VideoMAE-base clip vectors: kernel vs plain path", got, want,
                 COS_KERNEL_PLAIN)
    del clip_encoder

    # 5. SigLIP so400m vision from HF weights: the preset's fused W8A8 tower
    # (mean pooling: no MAP head), and the bf16 'cls' backend of the composite
    vcfg = siglip.SigLIPVisionConfig.so400m()
    vstate = siglip.convert_hf_siglip_vision(draw(L.siglip_vision_layout(vcfg)), vcfg)
    semantic = SigLIPSemanticEncoder.from_tower_state(
        vcfg, vstate, NaFlexConfig(quant_fused=True), dev)
    del vstate
    frames = [rng.integers(0, 256, (384, 384, 3), dtype=np.uint8) for _ in range(HF_FRAMES)]
    prepared = np.stack([semantic.region_extractor.prepare(f)[0] for f in frames])
    got = served("SigLIP so400m fused W8A8 (from HF weights)",
                 lambda: semantic.encode_images_batch(frames),
                 dict(FUSED_LAUNCHES, attention_fused_qkv=vcfg.num_layers))
    with uncounted():
        want = plain_pooled(semantic.backend, prepared)
    check_cosine("hf", f"SigLIP fused ({HF_FRAMES} frames): kernel vs plain path", got, want,
                 COS_KERNEL_PLAIN)
    nc = NaFlexConfig(pool_strategy="cls")
    cls_backend = TorchSigLIPBackend(semantic.backend.tower, nc.dtype, image_mean=nc.image_mean,
                                     image_std=nc.image_std, pool_strategy="cls")
    got = served("SigLIP so400m 'cls' backend", lambda: cls_backend(prepared)[1],
                 {"flash_attention": vcfg.num_layers + 1})
    with uncounted(), plain_attention():
        want = cls_backend(prepared)[1]
    check_cosine("hf", f"SigLIP 'cls' backend ({HF_FRAMES} frames): kernel vs plain path",
                 got, want, COS_KERNEL_PLAIN)
    del semantic

    # 6. SigLIP so400m text tower: 8 prompts at 64 positions
    tcfg = siglip.SigLIPTextConfig()
    text_tower = siglip.load_text_tower(
        tcfg, siglip.convert_hf_siglip_text(draw(L.siglip_text_layout(tcfg)), tcfg), dev)
    prompts = ["the player icon", "an enemy sprite", "the boss on screen", "a health bar",
               "a door", "a treasure chest", "a gold coin", "a sword"][:HF_PROMPTS]

    def tokenize(batch):
        return np.stack([seeded_ids(t, tcfg.max_position, tcfg.vocab_size) for t in batch])

    ids = torch.from_numpy(tokenize(prompts)).to(dev)
    with torch.inference_mode():
        got = served("SigLIP so400m text tower", lambda: text_tower(ids)["pooled"],
                     {"flash_attention": tcfg.num_layers})
        with uncounted(), plain_attention():
            want = text_tower(ids)["pooled"]
    share(f"SigLIP text ({HF_PROMPTS} prompts): pooled, kernel vs plain path", got, want)

    # 7. SAM ViT-base point-grid proposals named by the SigLIP pair: the HF
    # open-vocab composite, every proposal kept (score threshold -1)
    scfg = sam_vit.SamViTConfig()
    sam = sam_vit.load_sam_vit(scfg, sam_vit.convert_hf_sam(draw(L.sam_layout(scfg)), scfg), dev)

    def composite():
        return OpenVocabSamBackend(scfg, sam, cls_backend, text_tower, None, tokenize,
                                   grid=HF_SAM_GRID, score_threshold=-1.0)

    sam_frames = E.gameplay_frames(HF_SAM_FRAMES, seed=HF_SEED)
    indices = list(range(HF_SAM_FRAMES))

    def implied(results):      # the text tower once, the 'cls' tower once a frame with regions
        named = sum(1 for frame in results if any(frame))
        return {"flash_attention": tcfg.num_layers + (vcfg.num_layers + 1) * named}

    served_backend = composite()
    got = served("open-vocab composite (SAM ViT-base + SigLIP)",
                 lambda: (served_backend._text_cache.clear(),
                          served_backend(sam_frames, prompts, indices))[1], implied)
    with uncounted(), plain_attention():
        want = composite()(sam_frames, prompts, indices)

    def detections(results):
        return [[[(d["mask"].mask.tobytes(), tuple(vars(d["mask"].bbox).values()),
                   d["mask"].area_pixels) for d in concept] for concept in frame]
                for frame in results]

    if detections(got) != detections(want):
        raise AssertionError("hf: the composite's detections differ between the kernel and "
                             "the plain path")
    conf = [(a["mask"].confidence, b["mask"].confidence) for fa, fb in zip(got, want)
            for ca, cb in zip(fa, fb) for a, b in zip(ca, cb)]
    worst = max((abs(a - b) for a, b in conf), default=0.0)
    check_share("hf", f"composite: {len(conf)} detections on {HF_SAM_FRAMES} frames equal; "
                "scores max abs err", worst, HF_CONF_TOL)
    with uncounted():
        masks, iou = served_backend._proposals(sam_frames)
    log("hf", f"SAM ViT-base: {HF_SAM_GRID ** 2} point prompts a frame, masks "
        f"{tuple(masks.shape)}, {float(masks.mean()):.3f} of cells set, IoU "
        f"{iou.min():.3f}..{iou.max():.3f}")
    del sam, text_tower, cls_backend, served_backend

    elapsed = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("hf", f"phase 17 in {elapsed:.1f} s (budget {HF_BUDGET_S} s), allocator peak "
        f"{peak:.2f} GiB; wall ms {', '.join(f'{k} {v:.1f}' for k, v in walls.items())}; "
        f"launches {total}; {nvidia_smi()}")
    if elapsed > HF_BUDGET_S:
        raise AssertionError(f"hf: phase 17 took {elapsed:.1f} s, over its {HF_BUDGET_S} s")
    return total


# --------------------------------------------------------------------------
# phase 18: training the served decoder
# --------------------------------------------------------------------------

def rel_l2(x, ref) -> float:
    """||x - ref|| / ||ref|| (0 when both are 0)."""
    diff, norm = (x.float() - ref.float()).norm().item(), ref.float().norm().item()
    return diff / norm if norm else diff


def check_gradients(dev, base, model_cfg, train_cfg, tokens, mask) -> str:
    """GRAD_STEPS steps of the QA trainer on one batch from ``base``, along
    the f32 plain path's trajectory: at each step the kernel path (bf16),
    the plain path (bf16) and the f32 plain path take their loss and
    gradients at the same parameters (three models over one set of
    tensors), then the f32 gradients update them.  Every gradient and the
    loss of the kernel path must lie within BF16_ERR_RATIO x the plain
    path's error against f32, plus GRAD_FLOOR; B1 launches as implied on the
    kernel path, none on the plain paths."""
    import torch

    from gvl_tpu_torch.models.qwen3 import load_model
    from gvl_tpu_torch.ops.attention import flash_attention
    from gvl_tpu_torch.training import qa_lm_train as T

    truth = T.training_model(model_cfg.plain(), base, dev)
    shared = dict(truth.state_dict())
    paths = (("kernel", load_model(model_cfg, shared, dev), torch.bfloat16),
             ("plain", load_model(model_cfg.plain(), shared, dev), torch.bfloat16),
             ("f32", truth, torch.float32))      # last: its gradients make the update
    opt = T.qa_optimizer(train_cfg, truth.parameters())
    want_b1 = B1_PER_LAYER["remat 4096"] * model_cfg.num_layers
    worst, lines = 0.0, []
    with uncounted():
        for step in range(GRAD_STEPS):
            got = {}
            for name, model, dtype in paths:
                before = flash_attention.launches
                loss = T.qa_loss(model, tokens, mask, dtype)
                loss.backward()
                torch.cuda.synchronize()
                got[name] = (loss.item(), {n: p.grad for n, p in model.named_parameters()},
                             flash_attention.launches - before)
                if model is not truth:
                    for p in model.parameters():
                        p.grad = None
            launched = {name: n for name, (_, _, n) in got.items()}
            if launched != {"kernel": want_b1, "plain": 0, "f32": 0}:
                raise AssertionError(f"train: step {step} B1 launches {launched}, want "
                                     f"{want_b1} on the kernel path and none on the plain")
            (lk, gk, _), (lp, gp, _), (lt, gt, _) = got["kernel"], got["plain"], got["f32"]
            errs = [(rel_l2(gk[n], gt[n]), rel_l2(gp[n], gt[n]), n) for n in gt]
            errs.append((abs(lk - lt) / abs(lt), abs(lp - lt) / abs(lt), "loss"))
            for ek, ep, name in errs:
                share = ek / (BF16_ERR_RATIO * ep + GRAD_FLOOR)
                worst = max(worst, share)
                if share > 1 or not math.isfinite(ek):
                    raise AssertionError(
                        f"train: step {step} {name}: the kernel path's error {ek:.3g} against"
                        f" f32 passes {BF16_ERR_RATIO} x the plain path's {ep:.3g} + "
                        f"{GRAD_FLOOR}")
            ek_max = max(errs[:-1])
            lines.append(f"step {step} loss {lk:.6f} / {lp:.6f} / f32 {lt:.6f}, worst gradient"
                         f" {ek_max[2]} {ek_max[0]:.3g} (plain {ek_max[1]:.3g})")
            opt.step()
    del paths, truth, shared, opt
    return f"{'; '.join(lines)}; worst share of the limit {worst:.3f}"


def train_processes(dev, root: Path) -> str:
    """``train_qa_lm --geometry v5`` and ``finetune_lora --data`` as two
    processes, started together: each must exit 0 and write its files."""
    import os

    from gvl_tpu_torch.scripts import generate_training_data

    pairs = root / "pairs.json"
    generate_training_data.main(["--out", str(pairs), "--count", "24"])
    commands = {
        "train_qa_lm": (["gvl_tpu_torch.scripts.train_qa_lm", "--geometry", "v5",
                         "--init-from", str(QA_CKPT), "--steps", "2", "--batch-size", "2",
                         "--eval-samples", "8", "--out", str(root / "proc_qa_lm")],
                        root / "proc_qa_lm", ("params.npz", "qa_lm_config.json", "metrics.json")),
        "finetune_lora": (["gvl_tpu_torch.scripts.finetune_lora", "--data", str(pairs),
                           "--epochs", "1", "--output-dir", str(root / "proc_lora")],
                          root / "proc_lora", ("adapter_config.json", "adapter_final.npz")),
    }
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = {name: subprocess.Popen([sys.executable, "-m", *argv], cwd=REPO, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (argv, _, _) in commands.items()}
    notes = []
    try:
        for name, proc in procs.items():
            t0 = time.perf_counter()
            out, _ = proc.communicate(timeout=TRAIN_PROCESS_S)
            _, where, files = commands[name]
            missing = [f for f in files if not (where / f).exists()]
            if proc.returncode != 0 or missing:
                raise AssertionError(f"train: {name} exited {proc.returncode}, missing "
                                     f"{missing}; its output ends:\n{out[-3000:]}")
            tail = [line for line in out.splitlines() if "acc=" in line or "done:" in line]
            notes.append(f"{name} exit 0, {sorted(p.name for p in where.iterdir())}"
                         f" ({tail[-1].strip()[:120] if tail else ''})")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return "; ".join(notes)


def run_train(dev):
    """Phase 18 (the module docstring): the QA model's trainer, its LoRA
    trainer and the projector trainer on the card, and the two scripts."""
    import tempfile
    from dataclasses import replace

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gvl_tpu_torch.agent.config import ReasoningCoreConfig
    from gvl_tpu_torch.agent.core import create_reasoning_core
    from gvl_tpu_torch.device_times import _device_us
    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID, ByteTokenizer
    from gvl_tpu_torch.models.projector import ProjectorBank
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine
    from gvl_tpu_torch.ops.attention import flash_attention
    from gvl_tpu_torch.training import (
        MultimodalProjectorDataset,
        ProjectorTrainer,
        ProjectorTrainingConfig,
    )
    from gvl_tpu_torch.training import qa_lm_train as T

    start = time.perf_counter()
    base_cfg, base = T.load_qa_lm(QA_CKPT, device=dev)
    layers = base_cfg.num_layers
    model_cfg = replace(base_cfg, remat=True)
    cfg = T.QATrainConfig(steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, max_len=TRAIN_LEN,
                          pool_size=TRAIN_BATCH, seed=TRAIN_SEED, log_every=0,
                          compute_dtype="bfloat16", model=model_cfg, **TRAIN_PHASE_B)
    served = []

    # 1. train_qa_lm: per step its wall, loss and B1 launches; the profiler
    # over steps 3 and 4
    steps = []
    prof = profile(activities=[ProfilerActivity.CUDA])

    def on_step(i, loss):
        torch.cuda.synchronize()
        steps.append((time.perf_counter(), loss.item(), flash_attention.launches))
        if i + 1 == TRAIN_PROFILED[0]:
            prof.start()
        elif i + 1 == TRAIN_PROFILED[1]:
            prof.stop()

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    trained = T.train_qa_lm(cfg, init_params=base, device=dev, on_step=on_step)
    served.append(served_launches("train", ("flash_attention",)))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    per_step = np.diff([0] + [n for _, _, n in steps]).tolist()
    walls = np.diff([t0] + [t for t, _, _ in steps]) * 1e3
    losses = [loss for _, loss, _ in steps]
    step_ms = float(np.median(walls[1:]))
    kernels = _device_us(prof)
    window_ms = (steps[TRAIN_PROFILED[1] - 1][0] - steps[TRAIN_PROFILED[0] - 1][0]) * 1e3
    device_ms = sum(kernels.values()) / 1e3
    b1_ms = sum(v for k, v in kernels.items() if "flash_attention" in k) / 1e3
    n_win = TRAIN_PROFILED[1] - TRAIN_PROFILED[0]
    top = {k[:60]: round(v / 1e3 / n_win, 2)
           for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]}
    n_params = sum(t.numel() for t in base.values())
    log("train", f"train_qa_lm from {QA_CKPT.name} ({n_params / 1e6:.1f}M parameters, remat,"
        f" bf16 loss path), batch {TRAIN_BATCH} x {TRAIN_LEN}: ms per step "
        f"{', '.join(f'{w:.1f}' for w in walls)} (median of steps 1-{TRAIN_STEPS - 1} "
        f"{step_ms:.1f}; step 0 holds the model's build and the batch's rendering), "
        f"{TRAIN_BATCH * TRAIN_LEN / step_ms * 1e3:.0f} token positions/s; profiled steps "
        f"{TRAIN_PROFILED[0]}-{TRAIN_PROFILED[1] - 1}: device ms per step "
        f"{device_ms / n_win:.1f}, busy share {device_ms / window_ms:.3f}, B1 {b1_ms / n_win:.1f}"
        f" ms per step ({b1_ms / device_ms:.3f} of device time); top "
        f"{top};"
        f" allocator peak {peak:.2f} GiB; B1 launches per step {per_step}; losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; {nvidia_smi()}")
    if any(n != B1_PER_LAYER["remat 4096"] * layers for n in per_step):
        raise AssertionError(f"train: B1 launches per step {per_step}, want "
                             f"{B1_PER_LAYER['remat 4096'] * layers}")
    b1_per_step = per_step[0]      # measured: every step's count is this one
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses on the fixed batch {losses} do not fall")
    if not all(torch.isfinite(t).all() for t in trained.values()):
        raise AssertionError("train: a trained weight is not finite")

    # forward, backward and the optimizer of one step, timed apart (events)
    tokens, mask = (torch.from_numpy(a).to(dev) for a in T._render_batch(
        np.random.default_rng(TRAIN_SEED), cfg, ByteTokenizer()))
    with uncounted():
        model = T.training_model(model_cfg, base, dev)
        opt = T.qa_optimizer(cfg, model.parameters())
        for _ in range(2):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            marks[0].record()
            loss = T.qa_loss(model, tokens, mask, torch.bfloat16)
            marks[1].record()
            loss.backward()
            marks[2].record()
            opt.step()
            marks[3].record()
            torch.cuda.synchronize()
        parts = [marks[i].elapsed_time(marks[i + 1]) for i in range(3)]
        del model, opt
    # the plain attention backward alone (B1's delta recompute included) at
    # the step's shape, as each layer's backward calls it
    from gvl_tpu_torch.ops.attention import attention_backward

    q, g = (torch.randn(TRAIN_BATCH, base_cfg.num_heads, TRAIN_LEN, base_cfg.head_dim,
                        device=dev, dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(TRAIN_BATCH, base_cfg.num_kv_heads, TRAIN_LEN, base_cfg.head_dim,
                        device=dev, dtype=torch.bfloat16) for _ in range(2))
    with uncounted():
        bwd_ms = time_ms(lambda: attention_backward(q, k, v, g, causal=True), 3)
    del q, g, k, v
    log("train", f"one step timed apart (CUDA events): forward {parts[0]:.1f} ms, backward "
        f"(remat's recompute included) {parts[1]:.1f} ms, optimizer {parts[2]:.1f} ms; the "
        f"plain attention backward {bwd_ms:.1f} ms a layer, {bwd_ms * layers:.1f} ms a step "
        f"({bwd_ms * layers / sum(parts):.3f} of it)")

    # 2. the kernel path's gradients against the plain path's and f32
    log("train", f"{GRAD_ROWS} rows x {TRAIN_LEN}, {GRAD_STEPS} steps, gradients and loss "
        f"kernel / plain / f32: "
        + check_gradients(dev, base, model_cfg, replace(cfg, steps=GRAD_STEPS),
                          tokens[:GRAD_ROWS], mask[:GRAD_ROWS]))
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = Path(tmp)
        # 3. the trained weights saved and read back, then served
        T.save_qa_lm(trained, root / "qa_lm", base_cfg)
        cfg_back, back = T.load_qa_lm(root / "qa_lm", device=dev)
        if cfg_back != base_cfg or back.keys() != trained.keys() or not all(
                torch.equal(back[k], trained[k]) for k in trained):
            raise AssertionError("train: save_qa_lm -> load_qa_lm is not bit-equal")
        reset_launches()
        heldout = T.evaluate_qa_lm(back, cfg_back, n_samples=TRAIN_EVAL_SAMPLES, seed=QA_SEED,
                                   device=dev)
        served.append(served_launches("train", ("flash_attention", "decode_attention",
                                                "cache_append")))
        log("train", f"saved and reloaded bit-equal; {TRAIN_EVAL_SAMPLES} held-out answers: "
            f"accuracy {heldout['accuracy']:.3f}")
        del trained, back

        # 4. LoRA from outputs/qa_lm at LoraQAConfig's shapes
        lora_steps = []

        def on_lora(i, loss):
            torch.cuda.synchronize()
            lora_steps.append((time.perf_counter(), loss.item(), flash_attention.launches))

        reset_launches()
        t0 = time.perf_counter()
        lora_cfg, lora_state = T.train_qa_lm_lora(
            QA_CKPT, T.LoraQAConfig(steps=LORA_TRAIN_STEPS, seed=TRAIN_SEED, log_every=0),
            device=dev, on_step=on_lora)
        served.append(served_launches("train lora", ("flash_attention",)))
        lora_per_step = np.diff([0] + [n for _, _, n in lora_steps]).tolist()
        lora_walls = np.diff([t0] + [t for t, _, _ in lora_steps]) * 1e3
        frozen = [n for n in base if not torch.equal(lora_state[n], base[n])]
        still = [n for n in lora_state if n.endswith("lora_b") and not lora_state[n].any()]
        log("train", f"train_qa_lm_lora rank {lora_cfg.lora_rank}, batch "
            f"{T.LoraQAConfig.batch_size} x {T.LoraQAConfig.max_len}, f32: ms per step "
            f"{', '.join(f'{w:.1f}' for w in lora_walls)}, losses "
            f"{', '.join(f'{x:.4f}' for _, x, _ in lora_steps)}, B1 launches per step "
            f"{lora_per_step}; frozen tensors moved: {len(frozen)}; lora_b still zero: "
            f"{len(still)}")
        if frozen or still or any(n != B1_PER_LAYER["lora 2560"] * layers
                                  for n in lora_per_step):
            raise AssertionError(f"train lora: frozen tensors moved {frozen[:3]}, lora_b zero"
                                 f" {still[:3]}, B1 launches per step {lora_per_step}")
        T.save_qa_lm_adapter(lora_state, root / "adapter", lora_cfg, base_dir=QA_CKPT)
        del lora_state
        core = create_reasoning_core(checkpoint_path=str(QA_CKPT),
                                     lora_path=str(root / "adapter"), device=dev)
        engine = core.backend.engine
        timed = TimedEngine(engine)
        reset_launches()
        got = T.evaluate_qa_lm(n_samples=TRAIN_EVAL_SAMPLES, seed=QA_SEED, engine=timed)
        torch.cuda.synchronize()
        served.append(served_launches("train lora", ("flash_attention", "decode_attention",
                                                     "cache_append")))
        with uncounted():
            plain = Qwen3Engine(engine.config.plain(), engine.model.state_dict(),
                                eos_token_id=EOS_ID, device=dev)
            ref = T.evaluate_qa_lm(n_samples=TRAIN_EVAL_SAMPLES, seed=QA_SEED, engine=plain)
        agree = sum(a == b for a, b in zip(got["answers"], ref["answers"]))
        log("train", f"the trained adapter merged through create_reasoning_core(lora_path=): "
            f"{TRAIN_EVAL_SAMPLES} answers, accuracy {got['accuracy']:.3f}, {timed.summary()};"
            f" plain path equal {agree}/{TRAIN_EVAL_SAMPLES}")
        if agree != TRAIN_EVAL_SAMPLES:
            raise AssertionError(f"train lora: kernel and plain path agree on {agree} of "
                                 f"{TRAIN_EVAL_SAMPLES} answers")
        del core, engine, timed, plain
        torch.cuda.empty_cache()

        # 5. the projector trainer, generative objective over the frozen QA model
        rng = np.random.default_rng(TRAIN_SEED)
        feats = root / "features"
        feats.mkdir()
        rc = ReasoningCoreConfig(llm_hidden_dim=base_cfg.hidden_size)
        ts = np.arange(PROJ_ROWS) * 0.5
        np.savez(feats / "clip_embeddings.npz",
                 siglip=rng.standard_normal((PROJ_ROWS, rc.siglip_dim)).astype(np.float32),
                 siglip_ts=ts,
                 videomae=rng.standard_normal((PROJ_ROWS, rc.videomae_dim)).astype(np.float32),
                 wav2vec2=rng.standard_normal((PROJ_ROWS, rc.audiomae_dim)).astype(np.float32),
                 wav2vec2_ts=ts)
        (feats / "clip_features.json").write_text(json.dumps({
            "ocr": [{"timestamp": float(t), "texts": [f"SCORE {100 * i}"]}
                    for i, t in enumerate(ts[::2])],
            "transcription": [{"start": 2.0, "text": "enemy ahead take cover"}],
            "entities": [{"concept": "boss"}]}))
        pcfg = ProjectorTrainingConfig(epochs=1, batch_size=PROJ_BATCH,
                                       llm_dim=base_cfg.hidden_size,
                                       output_path=str(root / "projector_weights.pt"))
        kept = {k: v.clone() for k, v in base.items()}
        trainer = ProjectorTrainer(pcfg, reasoning_config=rc,
                                   llm=(base_cfg, base, ByteTokenizer().encode), device=dev)
        reset_launches()
        t0 = time.perf_counter()
        result = trainer.train(MultimodalProjectorDataset(feats))
        torch.cuda.synchronize()
        proj_s = time.perf_counter() - t0
        served.append(served_launches("train projector", ("flash_attention",)))
        n_proj = sum(len(h) for h in result["history"].values())
        proj_launches = served[-1]["flash_attention"]
        moved = [k for k, v in trainer.llm_model.state_dict().items()
                 if not torch.equal(v, kept[k])]
        bank = ProjectorBank(rc, device=dev)
        bank.load_weights(pcfg.output_path)
        x = rng.standard_normal((4, rc.siglip_dim)).astype(np.float32)
        f16_err = rel_l2(torch.from_numpy(bank.project_region(x)),
                         torch.from_numpy(trainer.bank.project_region(x)))
        log("train", f"ProjectorTrainer (generative, llm_dim {base_cfg.hidden_size}): {n_proj} "
            f"steps in {proj_s:.2f} s, losses {result['history']}, B1 launches {proj_launches}; "
            f"LLM tensors moved: {len(moved)}; projector_weights.pt through ProjectorBank: "
            f"relative error {f16_err:.2e} (f16 on disk)")
        if moved or proj_launches != B1_PER_LAYER["projector 33"] * layers * n_proj or \
                n_proj != 3 * PROJ_ROWS // PROJ_BATCH or f16_err > PROJ_F16_REL or not all(
                    math.isfinite(v) for h in result["history"].values() for v in h):
            raise AssertionError("train projector: the LLM moved, the launches or steps are not"
                                 " the implied ones, or the saved weights do not load")
        del trainer, kept

        # 6. the two scripts as processes
        log("train", train_processes(dev, root))

    elapsed = time.perf_counter() - start
    log("train", f"phase 18 in {elapsed:.1f} s (budget {TRAIN_BUDGET_S} s)")
    if elapsed > TRAIN_BUDGET_S:
        raise AssertionError(f"train: phase 18 took {elapsed:.1f} s, over its {TRAIN_BUDGET_S} s")
    total = {name: sum(run.get(name, 0) for run in served) for name in served[0]}
    return total, b1_per_step


# --------------------------------------------------------------------------
# Phase 19: the perception trainers
# --------------------------------------------------------------------------

class TrainerCase:
    """One perception trainer at its default config: how to draw its start,
    build a trainable model, draw a batch of its shapes, take its loss, run
    it for ``PT_STEPS`` steps, and save, reload and serve what it trained."""

    def __init__(self, name, geometry, b1_per_step, init, model, batch, loss, train, reload,
                 lr, steps=None):
        self.name, self.geometry, self.b1_per_step = name, geometry, b1_per_step
        self.init, self.model, self.batch, self.loss = init, model, batch, loss
        self.train, self.reload, self.lr = train, reload, lr
        self.steps = steps or PT_STEPS


def _trainable(case, state, dev):
    import torch

    from gvl_tpu_torch.training.init_laws import trainable

    with torch.device("meta"):
        model = case.model()
    return trainable(model, state, dev)


def _bit_equal(what: str, got: dict, want: dict) -> None:
    import torch

    if got.keys() != want.keys() or not all(
            torch.equal(got[k].cpu(), want[k].cpu()) for k in want):
        raise AssertionError(f"{what}: the reloaded weights are not bit-equal to the trained")


def _ocr_arrays(rng, config, batch: int, kind: str):
    """Seeded arrays of an OCR trainer's batch shapes (the card's machine has
    no Pillow to render text): crops and CTC labels of up to 16 ids, or
    canvases and their target maps."""
    import numpy as np

    if kind == "recognizer":
        images = rng.random((batch, config.rec_height, config.rec_width, 1)).astype(np.float32)
        lengths = rng.integers(0, 17, batch)
        labels = rng.integers(1, config.num_classes, (batch, 16)).astype(np.int32)
        pad = (np.arange(16)[None] >= lengths[:, None]).astype(np.float32)
        labels[pad > 0] = 0
        return images, labels, pad
    images = rng.random((batch, config.det_height, config.det_width, 1)).astype(np.float32)
    targets = (rng.random((batch, config.det_height // config.det_stride,
                           config.det_width // config.det_stride)) < 0.1).astype(np.float32)
    return images, targets


def _ocr_loop(net_fn, loss_fn, config, state, batches, dev, on_step):
    """The OCR trainers' step (``recognizer_loss`` / ``detector_loss`` under
    Optax's ``adam``, as ``train_recognizer`` and ``train_detector`` take
    it) over seeded arrays."""
    import torch

    from gvl_tpu_torch.training import init_laws, optim

    with torch.device("meta"):
        net = net_fn(config)
    net = init_laws.trainable(net, state, dev)
    opt = optim.AdamW(net.parameters(), 1e-3, clip=None, weight_decay=0.0)
    for i, batch in enumerate(batches):
        loss = optim.train_step(net, opt, lambda m: loss_fn(m, *batch))
        on_step(i, loss)
    return init_laws.state_of(net)


def perception_trainer_cases(dev) -> list:
    """The eight trainers (OCR's two nets apart, the SigLIP text tower's
    pretraining apart) at their default configs, seeded ``PT_SEED``."""
    import numpy as np
    import torch

    from gvl_tpu_torch.audio import event_model as E
    from gvl_tpu_torch.models import sam as SAM
    from gvl_tpu_torch.models.convert import hico_params_from_jax, sam_params_from_jax
    from gvl_tpu_torch.models.whisper import WhisperModel
    from gvl_tpu_torch.models.siglip import SigLIPTextTower
    from gvl_tpu_torch.nn.layers import load_module
    from gvl_tpu_torch.perception import ocr_model as O
    from gvl_tpu_torch.temporal import hico as H
    from gvl_tpu_torch.training import asr_train as A
    from gvl_tpu_torch.training import retriever_train as R
    from gvl_tpu_torch.training import segmenter_train as S
    from gvl_tpu_torch.training import siglip_train as G
    from gvl_tpu_torch.training import videomae_train as V

    def rng():
        return np.random.default_rng(PT_SEED)

    def on(arrays):
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    cases = []

    # the segmenter (SamConfig(): 256 px, encoder 384 x 6 x 6 heads)
    sam = SAM.SamConfig()
    scfg = S.SegTrainConfig(image_size=sam.image_size, steps=PT_STEPS, seed=PT_SEED, log_every=0)
    tokens = S.concept_tokens(sam, dev)

    def seg_reload(state, root):
        SAM.save_segmenter_npz(state, root / "sam_params.npz", sam)
        back = sam_params_from_jax(SAM.load_segmenter_npz(root / "sam_params.npz"), sam)
        with torch.device("meta"):
            net = SAM.PromptableSegmenter(sam)
        net = load_module(net, back, dev)
        frames = torch.from_numpy(S.make_batch(rng(), scfg, sam)[0][:2]).to(dev).float() / 255
        with torch.inference_mode():
            out = net(frames, tokens)
        return back, f"mask logits {list(out['mask_logits'].shape)}"

    cases.append(TrainerCase(
        "segmenter", f"SamConfig(): {sam.image_size} px, encoder {sam.encoder_dim} x "
        f"{sam.encoder_layers} x {sam.encoder_heads} heads, batch {scfg.batch_size}",
        sam.encoder_layers + sam.text_layers + 2 * sam.decoder_layers,
        lambda: S.segmenter_state(None, sam, PT_SEED), lambda: SAM.PromptableSegmenter(sam),
        lambda: on(S.make_batch(rng(), scfg, sam)), lambda m, b: S.segmenter_loss(m, tokens, *b),
        lambda init, on_step: S.train_segmenter(sam, scfg, init_params=init, device=dev,
                                                on_step=on_step),
        seg_reload, scfg.learning_rate))

    # the OCR nets (OCRModelConfig(rec_arch="v2")) on seeded arrays
    ocr = O.OCRModelConfig(rec_arch="v2")
    for kind, net_fn, loss_fn, batch in (
            ("recognizer", O.make_recognizer, O.recognizer_loss, 32),
            ("detector", O.TextDetectorNet, O.detector_loss, 8)):
        def ocr_reload(state, root, kind=kind):
            nets = O.init_ocr_params(ocr, PT_SEED)
            nets[kind] = state
            O.save_ocr_params(nets, str(root / "ocr_params.npz"), ocr)
            engine = O.TorchOCREngine(ocr, checkpoint=str(root / "ocr_params.npz"), device=dev)
            frame = (np.random.default_rng(PT_SEED).random((360, 640)) * 255).astype(np.uint8)
            found = engine(frame)
            return getattr(engine, kind).state_dict(), f"TorchOCREngine: {len(found)} lines"

        cases.append(TrainerCase(
            f"ocr {kind}", f"OCRModelConfig(rec_arch='v2'), batch {batch}, seeded arrays", 0,
            lambda net_fn=net_fn: O.ocr_net_state(None, net_fn, ocr, PT_SEED),
            lambda net_fn=net_fn: net_fn(ocr),
            lambda kind=kind, batch=batch: on(_ocr_arrays(rng(), ocr, batch, kind)),
            lambda m, b, loss_fn=loss_fn: loss_fn(m, *b),
            lambda init, on_step, kind=kind, batch=batch, net_fn=net_fn, loss_fn=loss_fn:
                _ocr_loop(net_fn, loss_fn, ocr, init, [on(_ocr_arrays(
                    np.random.default_rng(PT_SEED + i), ocr, batch, kind))
                    for i in range(PT_STEPS)], dev, on_step),
            ocr_reload, 1e-3))

    # the audio-event net
    ev = E.EventModelConfig()

    def ev_reload(state, root):
        E.save_event_params(state, root / "audio_event_params.npz")
        params = E.load_event_params(root / "audio_event_params.npz")
        detector = E.TorchAudioEventDetector(params, device=dev)
        audio = E.synth_event(rng(), "impact", E.EventModelConfig(window_seconds=2.0))
        events = detector(audio, ev.sample_rate)
        E.TrainedAudioEmbedder(params, device=dev)(audio, ev.sample_rate)
        return detector.net.state_dict(), f"TorchAudioEventDetector: {events}"

    cases.append(TrainerCase(
        "audio events", "EventModelConfig(), batch 64", 0,
        lambda: E.event_state(None, ev, PT_SEED), lambda: E.AudioEventNet(ev),
        lambda: on(E.make_event_batch(rng(), ev, 64)), lambda m, b: E.event_loss(m, *b),
        lambda init, on_step: E.train_event_model(
            ev, steps=PT_STEPS, seed=PT_SEED, pool_size=64 * PT_STEPS, init_params=init,
            device=dev, on_step=on_step),
        ev_reload, 1e-3))

    # the byte ASR (asr_config(): d 256, 4 + 4 layers, 300 source positions)
    acfg = A.ASRTrainConfig(steps=PT_STEPS, seed=PT_SEED, log_every=0)

    def asr_reload(state, root):
        A.save_asr(state, root / "asr", acfg.model)
        asr = A.TrainedByteASR.from_dir(root / "asr", device=dev)
        text, _ = asr(A.synth_speech(rng(), "boss incoming"), A.SAMPLE_RATE)
        return asr.model.state_dict(), f"TrainedByteASR: {text[:30]!r}"

    cases.append(TrainerCase(
        "byte ASR", f"asr_config(): d {acfg.model.d_model}, {acfg.model.encoder_layers} + "
        f"{acfg.model.decoder_layers} layers, {acfg.model.max_source_positions} source "
        f"positions, batch {acfg.batch_size}",
        acfg.model.encoder_layers + 2 * acfg.model.decoder_layers,
        lambda: A.asr_state(None, acfg.model, PT_SEED), lambda: WhisperModel(acfg.model),
        lambda: on(A._render_batch_seeded(acfg, PT_SEED + 1)),
        lambda m, b: A.asr_loss(m, *b),
        lambda init, on_step: A.train_asr(acfg, init_params=init, device=dev, on_step=on_step),
        asr_reload, acfg.learning_rate))

    # the mini-SigLIP pair (vision 384 x 6 at 128 px, text 384 x 4): the text
    # tower's corpus pretraining, then the VL steps from its tower
    gcfg = G.SigLIPTrainConfig(steps=PT_STEPS, seed=PT_SEED, log_every=0,
                               text_pretrain_steps=PT_PRETRAIN_STEPS)
    mp = gcfg.text.max_position

    def sig_batch():
        imgs, caps, cls = G.make_pairs(rng(), gcfg.batch_size, gcfg.canvas)
        return on((imgs, G.byte_tokenize(caps, mp), cls))

    def sig_train(init, on_step):
        from dataclasses import replace

        return G.train_minisiglip(replace(gcfg, text_pretrain_steps=0), init_params=init,
                                  device=dev, on_step=on_step)

    def sig_reload(state, root):
        G.save_minisiglip(state, root / "minisiglip", gcfg.vision, gcfg.text)
        model, _, _ = G.load_minisiglip(root / "minisiglip", device=dev)
        with torch.inference_mode():
            z = model.encode_text(torch.from_numpy(G.byte_tokenize(["the boss"], mp)).to(dev))
        return model.state_dict(), f"load_minisiglip: text embedding {list(z.shape)}"

    def corpus_batch():
        from gvl_tpu_torch.training.text_corpus import word_context_batch

        return on(word_context_batch(np.random.default_rng(PT_SEED + 7),
                                     gcfg.text_corpus_batch, mp))

    def pretrain_model():
        return G._TextPretrainer(gcfg.text)

    def pretrain_init():
        state = {f"text.{k}": v for k, v in G.text_tower_state(None, gcfg.text,
                                                                PT_SEED + 7).items()}
        state.update(logit_scale=torch.tensor(np.float32(np.log(10.0))),
                     logit_bias=torch.tensor(np.float32(-10.0)))
        return state

    def pretrain(init, on_step):
        text = {k[len("text."):]: v for k, v in init.items() if k.startswith("text.")}
        tower = G.pretrain_text_tower(gcfg, init_params=text, device=dev, on_step=on_step)
        return {**{f"text.{k}": v for k, v in tower.items()},
                "logit_scale": init["logit_scale"], "logit_bias": init["logit_bias"]}

    def pretrain_reload(state, root):
        text = {k[len("text."):]: v for k, v in state.items() if k.startswith("text.")}
        R.save_retriever(text, root / "text_tower", gcfg.text)
        embedder = R.TrainedTextEmbedder.from_dir(root / "text_tower", device=dev)
        z = embedder.encode(["the villain attacks"])
        return {f"text.{k}": v for k, v in embedder.tower.state_dict().items()} | {
            "logit_scale": state["logit_scale"], "logit_bias": state["logit_bias"]}, \
            f"the pretrained tower through TrainedTextEmbedder: {list(z.shape)}"

    cases.append(TrainerCase(
        "SigLIP text pretraining", f"text {gcfg.text.hidden_size} x {gcfg.text.num_layers}, "
        f"corpus batch {gcfg.text_corpus_batch}, {PT_PRETRAIN_STEPS} steps",
        2 * gcfg.text.num_layers, pretrain_init, pretrain_model, corpus_batch,
        lambda m, b: G.corpus_loss(m.encode, m.logit_scale, m.logit_bias, *b),
        pretrain, pretrain_reload, gcfg.learning_rate, steps=PT_PRETRAIN_STEPS))
    cases.append(TrainerCase(
        "mini-SigLIP", f"vision {gcfg.vision.hidden_size} x {gcfg.vision.num_layers} at "
        f"{gcfg.vision.image_size} px, text {gcfg.text.hidden_size} x {gcfg.text.num_layers}, "
        f"batch {gcfg.batch_size}",
        gcfg.vision.num_layers + 1 + gcfg.text.num_layers,
        lambda: G.minisiglip_state(None, gcfg), lambda: G.MiniSigLIP(gcfg.vision, gcfg.text),
        sig_batch, lambda m, b: G.minisiglip_loss(m, *b), sig_train, sig_reload,
        gcfg.learning_rate))

    # the retriever's text tower
    rcfg = R.RetrieverTrainConfig(steps=PT_STEPS, seed=PT_SEED, log_every=0)

    def ret_batch():
        q, d = R.make_batch(rng(), rcfg.batch_size)
        return on((R.tokenize(q, rcfg.model.max_position), R.tokenize(d, rcfg.model.max_position)))

    def ret_reload(state, root):
        R.save_retriever(state, root / "retriever", rcfg.model)
        embedder = R.TrainedTextEmbedder.from_dir(root / "retriever", device=dev)
        z = embedder.encode(["when does the boss appear"])
        return embedder.tower.state_dict(), f"TrainedTextEmbedder: {list(z.shape)}"

    cases.append(TrainerCase(
        "retriever", f"retriever_text_config(): {rcfg.model.hidden_size} x "
        f"{rcfg.model.num_layers}, {rcfg.model.max_position} positions, batch {rcfg.batch_size}",
        2 * rcfg.model.num_layers,
        lambda: R.retriever_state(None, rcfg.model, PT_SEED), lambda: SigLIPTextTower(rcfg.model),
        ret_batch, lambda m, b: R.retriever_loss(m, *b, rcfg.temperature),
        lambda init, on_step: R.train_retriever(rcfg, init_params=init, device=dev,
                                                on_step=on_step),
        ret_reload, rcfg.learning_rate))

    # the VideoMAE clip classifier (256 x 6, 16 frames at 112 px)
    vcfg = V.ClipTrainConfig(steps=PT_STEPS, seed=PT_SEED, log_every=0)
    vm = vcfg.model

    def vm_batch():
        return on(V.make_batch(rng(), vcfg.batch_size, vm.image_size, vm.num_frames, vcfg.styles))

    def vm_reload(state, root):
        V.save_clip_encoder(state, root / "videomae", vm)
        enc = V.TrainedClipEncoder.from_dir(root / "videomae", device=dev)
        clip = V.make_batch(rng(), 1, vm.image_size, vm.num_frames, ("base",))[0][0]
        return enc.model.state_dict(), f"TrainedClipEncoder: {enc.classify_clips([clip])[0]}"

    cases.append(TrainerCase(
        "VideoMAE", f"mini_videomae_config(): {vm.hidden_size} x {vm.num_layers}, "
        f"{vm.num_frames} frames at {vm.image_size} px, batch {vcfg.batch_size}",
        vm.num_layers, lambda: V.clip_state(None, vm, PT_SEED), lambda: V.ClipClassifier(vm),
        vm_batch, lambda m, b: V.clip_loss(m, *b),
        lambda init, on_step: V.train_clip_encoder(vcfg, init_params=init, device=dev,
                                                   on_step=on_step),
        vm_reload, vcfg.learning_rate))

    # HiCo's FRAME -> CLIP pool (1408 wide) with its throwaway decoder
    hico = H.HiCoConfig()
    hcfg = H.HicoTrainConfig(steps=PT_STEPS, seed=PT_SEED, log_every=0)

    def hico_batch():
        return on((H.make_sequences(rng(), hcfg.batch_size, hcfg.frames_per_clip,
                                    hico.hidden_dim).astype(np.float32),))

    def hico_train(init, on_step):
        comp = H.train_hico(hico, hcfg, init_params=init, device=dev, on_step=on_step)
        decoder = {k: v for k, v in init.items() if k.startswith("decoder.")}
        return {**{f"compressor.{k}": v for k, v in comp.items()}, **decoder}

    def hico_reload(state, root):
        comp = {k[len("compressor."):]: v for k, v in state.items()
                if k.startswith("compressor.")}
        H.save_hico_npz(comp, root / "hico_params.npz")
        back = hico_params_from_jax(H.load_hico_npz(root / "hico_params.npz"))
        with torch.device("meta"):
            net = H.HierarchicalCompressor(hico, pools=("frame_to_clip",))
        net = load_module(net, back, dev)
        with torch.inference_mode():
            out = net.compress_frames_to_clip(hico_batch()[0], hcfg.clip_tokens)
        return ({f"compressor.{k}": v for k, v in back.items()}
                | {k: v for k, v in state.items() if k.startswith("decoder.")},
                f"load_hico_npz: clip tokens {list(out.shape)} (the decoder is not saved)")

    cases.append(TrainerCase(
        "HiCo", f"HiCoConfig(): {hico.hidden_dim} wide, {hico.num_heads} heads, batch "
        f"{hcfg.batch_size} x {hcfg.frames_per_clip} frames", 1,
        lambda: H.hico_train_state(None, hico, hcfg),
        lambda: H.HicoTrainWrapper(hico, hcfg.frames_per_clip, hcfg.clip_tokens),
        hico_batch, lambda m, b: H.hico_loss(m, *b, hcfg.temperature), hico_train, hico_reload,
        hcfg.learning_rate))
    return cases


def _grads(model, case, batch) -> tuple[float, dict]:
    """The loss and every parameter's gradient (zeros where the loss does
    not reach it) of one backward; the model's gradients are cleared."""
    import torch

    loss = case.loss(model, batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.item(), grads


def kernel_against_plain(case, state, batch, dev) -> str:
    """At ``state`` on ``batch``: the loss and every gradient of the kernel
    path within ``PT_GRAD_REL`` of the plain path's (relative L2, each
    gradient's norm floored at ``PT_GRAD_FLOOR`` of the whole gradient's);
    the kernel path launches B1 as implied, the plain path not at all."""
    from gvl_tpu_torch.nn.layers import set_flash_kernel
    from gvl_tpu_torch.ops.attention import flash_attention

    model = _trainable(case, state, dev)
    with uncounted():
        before = flash_attention.launches
        lk, gk = _grads(model, case, batch)
        mid = flash_attention.launches
        set_flash_kernel(model, False)
        lp, gp = _grads(model, case, batch)
        after = flash_attention.launches
    if (mid - before, after - mid) != (case.b1_per_step, 0):
        raise AssertionError(f"perception train {case.name}: B1 launches kernel / plain path "
                             f"{mid - before} / {after - mid}, want {case.b1_per_step} / 0")
    total = math.sqrt(sum(float(g.float().norm()) ** 2 for g in gp.values()))
    worst = (abs(lk - lp) / abs(lp), "loss")
    for name, g in gp.items():
        err = float((gk[name].float() - g.float()).norm()) / max(float(g.float().norm()),
                                                                 PT_GRAD_FLOOR * total)
        worst = max(worst, (err, name))
    if not worst[0] <= PT_GRAD_REL or not math.isfinite(lk):
        raise AssertionError(f"perception train {case.name}: kernel path against plain path: "
                             f"{worst[1]} off by {worst[0]:.3g} (limit {PT_GRAD_REL})")
    del model
    return f"loss {lk:.6f} / {lp:.6f}, worst {worst[1]} {worst[0]:.2e}"


def timed_attention_backward():
    """A context in which each plain attention backward is timed with CUDA
    events; yields the list of (ms) it fills."""
    import torch

    from gvl_tpu_torch.ops import attention

    times = []
    plain = attention.attention_backward

    def timed(*args, **kw):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks[0].record()
        out = plain(*args, **kw)
        marks[1].record()
        times.append(marks)
        return out

    @contextlib.contextmanager
    def scope():
        attention.attention_backward = timed
        try:
            yield times
        finally:
            attention.attention_backward = plain

    return scope()


def run_trainer_case(case, dev) -> dict:
    """One trainer: the kernel path against the plain path at its start; the
    loss falling over ``PT_FIXED_STEPS`` steps of Adam on its first batch;
    the trainer's own steps (wall and device ms, busy and B1 shares, B1
    launches per step, allocator peak, finite losses); the trained weights
    saved, reloaded bit-equal and served."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gvl_tpu_torch.device_times import _device_us
    from gvl_tpu_torch.ops.attention import flash_attention

    from gvl_tpu_torch.training import optim

    init = case.init()
    batch = case.batch()
    check = kernel_against_plain(case, init, batch, dev)
    with uncounted():
        model = _trainable(case, init, dev)
        # the plain attention backward of one step, timed apart
        with timed_attention_backward() as marks:
            case.loss(model, batch).backward()
        torch.cuda.synchronize()
        bwd_ms = sum(a.elapsed_time(b) for a, b in marks)
        # progress: PT_FIXED_STEPS steps of Adam at the trainer's learning
        # rate on the fixed first batch
        opt = optim.AdamW(model.parameters(), case.lr, clip=None, weight_decay=0.0)
        fixed = [optim.train_step(model, opt, lambda m: case.loss(m, batch)).item()
                 for _ in range(PT_FIXED_STEPS)]
        with torch.no_grad():
            fixed.append(case.loss(model, batch).item())
        del model, opt

    steps = []
    prof = profile(activities=[ProfilerActivity.CUDA])

    window = (1, case.steps)      # the profiler's steps: all but the first

    def on_step(i, loss):
        torch.cuda.synchronize()
        steps.append((time.perf_counter(), loss.item(), flash_attention.launches))
        if i + 1 == window[0]:
            prof.start()
        elif i + 1 == window[1]:
            prof.stop()

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    trained = case.train(init, on_step)
    torch.cuda.synchronize()
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    per_step = np.diff([0] + [n for _, _, n in steps]).tolist()
    walls = np.diff([t0] + [t for t, _, _ in steps]) * 1e3
    n_win = window[1] - window[0]
    window_ms = (steps[window[1] - 1][0] - steps[window[0] - 1][0]) * 1e3
    kernels = _device_us(prof)
    device_ms = sum(kernels.values()) / 1e3 / n_win
    b1_ms = sum(v for k, v in kernels.items() if "flash_attention" in k) / 1e3 / n_win
    if any(n != case.b1_per_step for n in per_step) or any(
            n for k, n in launches.items() if k != "flash_attention"):
        raise AssertionError(f"perception train {case.name}: B1 launches per step {per_step}, "
                             f"want {case.b1_per_step}; launches {launches}")
    losses = [loss for _, loss, _ in steps]
    if not all(map(math.isfinite, fixed + losses)) or not fixed[-1] < fixed[0] or not all(
            torch.isfinite(t).all() for t in trained.values()):
        raise AssertionError(f"perception train {case.name}: the loss on the fixed batch went "
                             f"{fixed}, the trainer's {losses}, or a trained weight is not "
                             f"finite")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ptrain_") as tmp:
        reset_launches()
        back, note = case.reload(trained, Path(tmp))
        torch.cuda.synchronize()
        served_b1 = flash_attention.launches
    _bit_equal(f"perception train {case.name}", dict(back), trained)
    if case.b1_per_step and not served_b1:
        raise AssertionError(f"perception train {case.name}: the reloaded model served "
                             f"without B1")
    step_ms = float(np.median(walls[1:]))
    row = dict(name=case.name, geometry=case.geometry, step_ms=step_ms,
               device_ms=device_ms, busy=device_ms * n_win / window_ms,
               b1_share=b1_ms / device_ms if device_ms else 0.0,
               bwd_share=bwd_ms / device_ms if device_ms else 0.0,
               peak_gib=peak, b1_per_step=per_step[0], b1_launches=sum(per_step) + served_b1)
    log("perception train", f"{case.name} ({case.geometry}): kernel vs plain {check}; ms per "
        f"step {', '.join(f'{w:.1f}' for w in walls)} (median of steps 1-{PT_STEPS - 1} "
        f"{step_ms:.1f}); device ms per step {device_ms:.2f}, busy share {row['busy']:.3f}, B1 "
        f"{b1_ms:.3f} ms ({row['b1_share']:.3f} of device time), plain attention backward "
        f"{bwd_ms:.3f} ms ({row['bwd_share']:.3f}); allocator peak {peak:.2f} GiB; B1 launches"
        f" per step {per_step}; the trainer's losses {', '.join(f'{x:.5f}' for x in losses)}; "
        f"on the fixed batch {' -> '.join(f'{x:.5f}' for x in fixed)}; saved, "
        f"reloaded bit-equal, served ({note}; B1 launches {served_b1})")
    return row


PT_SCRIPTS = (
    ("train_segmenter", ["--eval-scenes", "2"], "sam_params.npz"),
    ("train_audio_events", ["--pool-size", "128", "--eval-samples", "12"],
     "audio_event_params.npz"),
    ("train_asr", ["--eval-samples", "2"], "asr"),
    ("train_siglip", ["--text-pretrain-steps", "2", "--eval-crops", "8"], "minisiglip"),
    ("train_retriever", ["--eval-timelines", "4"], "retriever"),
    ("train_videomae", ["--eval-clips", "4", "--pool-batches", "2"], "videomae"),
    ("train_hico", [], "hico_params.npz"),
)


def perception_train_processes(root: Path) -> str:
    """The trainers' scripts (``--steps 2``) as processes, at most
    ``PT_SCRIPTS_AT_ONCE`` at a time, each within ``PT_SCRIPT_S``: each must
    exit 0 and write its file.  ``train_ocr`` renders its text with Pillow,
    which the card's machine lacks: its trainers are held to JAX on the
    CPU."""
    import os

    env = {**os.environ, "PYTHONPATH": str(REPO)}
    pending, running, notes = list(PT_SCRIPTS), {}, []
    try:
        while pending or running:
            while pending and len(running) < PT_SCRIPTS_AT_ONCE:
                name, extra, out = pending.pop(0)
                argv = [sys.executable, "-m", f"gvl_tpu_torch.scripts.{name}", "--steps", "2",
                        "--out", str(root / out), *extra]
                running[name] = (subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                                                  stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT),
                                 time.perf_counter(), out)
            name = next(iter(running))
            proc, t0, out = running.pop(name)
            text, _ = proc.communicate(timeout=max(1.0, PT_SCRIPT_S - (time.perf_counter() - t0)))
            if proc.returncode != 0 or not (root / out).exists():
                raise AssertionError(f"perception train: {name} exited {proc.returncode}, "
                                     f"{out} written: {(root / out).exists()}; its output "
                                     f"ends:\n{text[-3000:]}")
            notes.append(f"{name} exit 0 in {time.perf_counter() - t0:.1f} s")
    finally:
        for proc, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return "; ".join(notes)


def run_perception_train(dev):
    """Phase 19 (the module docstring): the eight perception trainers at
    their default configs on the card, and their scripts."""
    import tempfile

    import torch

    start = time.perf_counter()
    rows = []
    for case in perception_trainer_cases(dev):
        rows.append(run_trainer_case(case, dev))
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pscripts_") as tmp:
        log("perception train", perception_train_processes(Path(tmp)))
    elapsed = time.perf_counter() - start
    log("perception train", f"phase 19 in {elapsed:.1f} s (budget {PT_BUDGET_S} s)")
    if elapsed > PT_BUDGET_S:
        raise AssertionError(f"perception train: phase 19 took {elapsed:.1f} s, over its "
                             f"{PT_BUDGET_S} s")
    launched = sum(row["b1_launches"] for row in rows)
    return {"flash_attention": launched}, rows


# --------------------------------------------------------------------------
# phase 20: multi-device on one card
# --------------------------------------------------------------------------

MESH_SEED = 20
MESH_BUDGET_S = 180
MESH_RANK_S = 170            # each process of the gloo world
MESH_PROMPT, MESH_STEPS = 128, 16
MESH_QA_PROMPTS = 8          # phase 5's first prompts, on QA_SLOTS slots
MESH_RING_SHAPE = (1, 8, 8192, 128)   # [B, H, S, D] bf16, S split over 2 ranks
MESH_FRAMES = 8
MESH_DEPLOY_S = 120          # torchrun's two processes serving
MESH_TAIL = [11, 12, 13]     # a next turn's new tokens after an answer (8B session)
# TP 2 at bf16: the all-reduce sums two bf16 partial products in another
# order and rounds each once more, a change of the size of bf16's own
# rounding; so the sharded bf16 logits may stray from the unsharded bf16
# run's by no more than that run strays from the f32 one (relative L2)
MESH_BF16_RATIO = 1.0
# ring attention in bf16 against f32 full attention: at most twice the
# plain bf16 path's error (relative L2), or 2**-8 where that is smaller
MESH_RING_RATIO, MESH_RING_FLOOR = 2.0, 2 ** -8
COS_DP = 0.99999             # data-parallel pooled embeddings against one rank
# phase 21: the rest of gvl_tpu's public surface.  The decoder-family
# nn.TransformerStack at the 8B layer geometry the repository serves
# (__graft_entry__.py: hidden 4096, 32 q / 8 kv heads of 128, FFN 12288,
# rope base 1e6), depth 2, bf16, one sequence of 2048 tokens
SURFACE_SEED = 21
SURFACE_GEOMETRY = dict(dim=4096, num_heads=32, intermediate_dim=12288, num_kv_heads=8,
                        head_dim=128, norm="rmsnorm", mlp="swiglu", causal=True, rope=True,
                        rope_base=1e6, qk_norm=True, use_bias=False)
SURFACE_LAYERS, SURFACE_SEQ = 2, 2048
SURFACE_BUDGET_S = 90


def implied_tp(cfg, steps: int) -> dict[str, int]:
    """A TP rank's launches for one prefill and ``steps`` decode steps of a
    ``cfg`` decoder: B1 once a layer, B2 and B3 (B4 and B5 with
    ``scan_layers``) once a layer and step."""
    decode = ("decode_attention_stacked", "cache_append_stacked") if cfg.scan_layers \
        else ("decode_attention", "cache_append")
    return {"flash_attention": cfg.num_layers,
            **{name: cfg.num_layers * steps for name in decode}}


def check_implied(phase: str, launches: dict, want: dict) -> None:
    wrong = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if wrong:
        raise AssertionError(f"{phase}: launches (got, implied) {wrong}")


def mesh_prompt(cfg):
    import torch

    return torch.randint(0, cfg.vocab_size, (MESH_PROMPT,),
                         generator=torch.Generator().manual_seed(MESH_SEED))


def greedy_trace(engine, prompt, steps: int, feed=None) -> dict:
    """Prefill ``prompt`` and ``steps`` decode steps through the engine's
    model (greedy, or the tokens of ``feed``): tokens, last-position logits,
    decode seconds and the collectives' seconds over the decode steps."""
    import torch

    from gvl_tpu_torch.models.qwen3 import KVCache
    from gvl_tpu_torch.parallel import collectives

    dev, cfg = engine.device, engine.config
    with torch.inference_mode():
        cache = KVCache.zeros(cfg, 1, dtype=engine.dtype, device=dev, mesh=engine.mesh)
        logits, cache = engine.model(prompt[None].to(dev),
                                     positions=torch.arange(len(prompt), device=dev),
                                     cache=cache)
        out = [logits[:, -1].float()]
        tokens = [int(out[-1].argmax(-1))]
        torch.cuda.synchronize()
        collectives.reset_stats()
        start = time.perf_counter()
        for i in range(steps):
            fed = tokens[-1] if feed is None else feed[i]
            logits, cache = engine.model(torch.tensor([[fed]], device=dev),
                                         positions=torch.tensor([cache.length], device=dev),
                                         cache=cache)
            out.append(logits[:, -1].float())
            tokens.append(int(out[-1].argmax(-1)))
        torch.cuda.synchronize()
    return {"tokens": tokens, "logits": out, "decode_s": time.perf_counter() - start,
            "collective_s": collectives.stats["seconds"],
            "collective_calls": collectives.stats["calls"]}


def rel_l2(x, ref) -> float:
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


def on_card(engine) -> bool:
    return all(t.is_cuda for t in engine.model.state_dict().values())


def mesh_nccl(dev) -> dict:
    """Phase 20 (a): an NCCL world of one rank, the 8B geometry at a 1 x 1
    mesh against the unsharded engine, bit for bit."""
    import tempfile

    import torch

    from gvl_tpu_torch.entry import flagship_config
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine, init_params
    from gvl_tpu_torch.parallel.mesh import (
        MeshManager,
        build_mesh,
        init_distributed,
        shutdown_distributed,
    )

    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        init_distributed(init_method=f"file://{tmp}/store", world_size=1, rank=0,
                         local_rank=0, local_world_size=1, device="cuda")
        try:
            mm = MeshManager(build_mesh(1, 1))
            if mm.backend != "nccl":
                raise AssertionError(f"mesh (a): {mm.describe()}, not NCCL")
            cfg = flagship_config()
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(MESH_SEED),
                                 dtype=torch.bfloat16, device=dev)
            alone = Qwen3Engine(cfg, params, eos_token_id=-1, device=dev)
            meshed = Qwen3Engine(cfg, params, eos_token_id=-1, device=dev, mesh=mm)
            prompt = mesh_prompt(cfg)
            with uncounted():
                for engine in (alone, meshed):      # lazy kernel loads, allocator growth
                    greedy_trace(engine, prompt, 2)
                want = greedy_trace(alone, prompt, MESH_STEPS)
                want_gen = alone.generate(prompt.tolist(), max_new_tokens=MESH_STEPS,
                                          temperature=0.0)
                got = greedy_trace(meshed, prompt, MESH_STEPS)
            reset_launches()
            got_gen = meshed.generate(prompt.tolist(), max_new_tokens=MESH_STEPS,
                                      temperature=0.0)
            launches = served_launches("mesh", ("flash_attention", "decode_attention",
                                                "cache_append"))
            check_implied("mesh (a)", launches, implied_tp(cfg, MESH_STEPS))
            same = all(torch.equal(a, b) for a, b in zip(got["logits"], want["logits"]))
            ok = same and got["tokens"] == want["tokens"] and got_gen == want_gen
            log("mesh", f"(a) {mm.describe()}: 8B geometry depth {cfg.num_layers} bf16, "
                f"prefill {MESH_PROMPT} + {MESH_STEPS} greedy steps: logits "
                f"{'bit-equal' if same else 'DIFFER'} to the unsharded engine's, tokens "
                f"{'equal' if ok else 'DIFFER'}; decode {1e3 * got['decode_s'] / MESH_STEPS:.3f}"
                f" ms/step against {1e3 * want['decode_s'] / MESH_STEPS:.3f} unsharded, "
                f"collectives {1e3 * got['collective_s'] / MESH_STEPS:.3f} ms/step "
                f"({got['collective_calls'] // MESH_STEPS} calls, host clock); {nvidia_smi()}")
            if not ok:
                raise AssertionError("mesh (a): the 1 x 1 NCCL mesh differs from no mesh")
            del alone, meshed, params
            torch.cuda.empty_cache()
            return launches
        finally:
            shutdown_distributed()


def gloo_probe() -> str:
    """Phase 0's note: which gloo collectives take CUDA tensors here, tried
    in a world of one rank."""
    import tempfile

    import torch.distributed as dist

    from gvl_tpu_torch.parallel.collectives import gloo_cuda_support

    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=1,
                                rank=0)
        try:
            support = gloo_cuda_support()
        finally:
            dist.destroy_process_group()
    return ", ".join(f"{name} {said}" for name, said in support.items())


# ---- the gloo world's ranks (each a process: python -c "...mesh_process(...)")

def rank_log(rank: int, message: str) -> None:
    log(f"mesh r{rank}", message)


def mesh_tp(mm, rank: int) -> dict:
    """TP 2 at the 8B geometry, depth 4: f32, bf16, int8 and scan_layers,
    each served through Qwen3Engine(mesh=) with the launches implied, rank
    0 holding each to the unsharded engine on the card."""
    import dataclasses

    import torch

    from gvl_tpu_torch.entry import flagship_config
    from gvl_tpu_torch.models.qwen3 import (
        Qwen3Engine,
        init_params,
        quantize_int8,
        stack_layers,
    )

    dev = mm.device
    cfg = flagship_config()
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(MESH_SEED),
                       dtype=torch.float32, device=dev)
    prompt = mesh_prompt(cfg)
    variants = (("f32", cfg, lambda: full),
                ("bf16", cfg, lambda: {k: v.bfloat16() for k, v in full.items()}),
                ("int8", dataclasses.replace(cfg, quant_int8=True),
                 lambda: quantize_int8(full, cfg)),
                ("scan", dataclasses.replace(cfg, scan_layers=True),
                 lambda: stack_layers(full, cfg)))
    # every variant's logits are taken along the f32 TP run's greedy tokens
    # (the same on both ranks), so that they compare step by step
    rows, truth, launched, feed = {}, None, {}, None
    for name, c, make in variants:
        state = make()
        engine = Qwen3Engine(c, state, eos_token_id=-1, device=dev, mesh=mm)
        if not on_card(engine):
            raise AssertionError(f"mesh tp {name}: a tensor is off the card")
        reset_launches()
        tokens = engine.generate(prompt.tolist(), max_new_tokens=MESH_STEPS, temperature=0.0)
        launches = kernel_launches()
        check_implied(f"mesh tp {name}", launches, implied_tp(c, MESH_STEPS))
        for k, v in launches.items():
            launched[k] = launched.get(k, 0) + v
        with uncounted():
            got = greedy_trace(engine, prompt, MESH_STEPS, feed)
        feed = feed or got["tokens"][:MESH_STEPS]
        row = {"tokens": tokens, "decode_ms": 1e3 * got["decode_s"] / MESH_STEPS,
               "collective_ms": 1e3 * got["collective_s"] / MESH_STEPS,
               "collective_calls": got["collective_calls"] // MESH_STEPS,
               "launches": {k: v for k, v in launches.items() if v}}
        if rank == 0:
            ref = Qwen3Engine(c, state, eos_token_id=-1, device=dev)
            with uncounted():
                want_tokens = ref.generate(prompt.tolist(), max_new_tokens=MESH_STEPS,
                                           temperature=0.0)
                want = greedy_trace(ref, prompt, MESH_STEPS, feed)
            del ref
            row.update(alone_ms=1e3 * want["decode_s"] / MESH_STEPS,
                       alone_tokens=want_tokens, same_tokens=sum(
                           a == b for a, b in zip(tokens, want_tokens)))
            errs = [rel_l2(a, b) for a, b in zip(got["logits"], want["logits"])]
            row["logit_rel_l2"] = max(errs)
            if name == "f32":
                truth = want
            if name == "bf16":
                own = max(rel_l2(a, b) for a, b in zip(want["logits"], truth["logits"]))
                row["bound"] = MESH_BF16_RATIO * own
                ok = row["logit_rel_l2"] <= row["bound"]
            else:
                ok = tokens == want_tokens
            rank_log(rank, f"tp {name}: tokens {row['same_tokens']}/{len(tokens)} equal to "
                     f"the unsharded engine's, logits relative L2 {row['logit_rel_l2']:.2e}"
                     + (f" (bound {row['bound']:.2e}: the unsharded bf16 run's own "
                        f"distance from f32)" if name == "bf16" else "")
                     + f"; decode {row['decode_ms']:.3f} ms/step against "
                     f"{row['alone_ms']:.3f} unsharded, collectives "
                     f"{row['collective_ms']:.3f} ms/step ({row['collective_calls']} calls); "
                     f"launches {row['launches']} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"mesh tp {name}: the TP 2 run strays from the "
                                     "unsharded engine")
        rows[name] = row
        del engine, state
        torch.cuda.empty_cache()
    del full
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": launched}


def mesh_qa(meshes: dict, rank: int, prompts) -> dict:
    """The trained QA model through ContinuousBatchingEngine(mesh=) at 2 x 1
    and 1 x 2: every answer equal to the unsharded engine's."""
    import torch

    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
    from gvl_tpu_torch.parallel import collectives
    from gvl_tpu_torch.serving import ContinuousBatchingEngine
    from gvl_tpu_torch.training.qa_lm_train import load_qa_lm

    dev = meshes["2x1"].device
    cfg, state = load_qa_lm(QA_CKPT, device=dev)
    want = None
    if rank == 0:
        ref = ContinuousBatchingEngine(cfg, state, eos_token_id=EOS_ID, num_slots=QA_SLOTS,
                                       device=dev)
        with uncounted():
            start = time.perf_counter()
            want = ref.generate_many(prompts, QA_MAX_NEW)
            torch.cuda.synchronize()
            alone_s = time.perf_counter() - start
        del ref
    rows, launched = {}, {}
    for name, mm in meshes.items():
        engine = ContinuousBatchingEngine(cfg, state, eos_token_id=EOS_ID,
                                          num_slots=QA_SLOTS, device=dev, mesh=mm)
        reset_launches()
        collectives.reset_stats()
        start = time.perf_counter()
        got = engine.generate_many(prompts, QA_MAX_NEW)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = kernel_launches()
        missing = [k for k in ("chunk_attention", "decode_attention", "cache_append")
                   if not launches[k]]
        if missing or launches["cache_append"] != launches["decode_attention"]:
            raise AssertionError(f"mesh qa {name}: launches {launches}")
        for k, v in launches.items():
            launched[k] = launched.get(k, 0) + v
        rows[name] = {"seconds": seconds, "tokens": sum(len(g) for g in got),
                      "collective_s": collectives.stats["seconds"],
                      "collective_calls": collectives.stats["calls"],
                      "launches": {k: v for k, v in launches.items() if v}}
        if rank == 0:
            same = sum(a == b for a, b in zip(got, want))
            rows[name].update(same=same, alone_s=alone_s)
            rank_log(rank, f"qa {name} ({mm.describe()}): {len(prompts)} prompts on "
                     f"{QA_SLOTS} slots, answers equal to the unsharded engine's {same}/"
                     f"{len(prompts)}; {rows[name]['tokens']} tokens in {seconds:.2f} s "
                     f"(unsharded {alone_s:.2f} s), collectives "
                     f"{rows[name]['collective_s']:.2f} s in {rows[name]['collective_calls']}"
                     f" calls; launches {rows[name]['launches']}")
            if same != len(prompts):
                raise AssertionError(f"mesh qa {name}: answers differ from the unsharded "
                                     "engine's")
        del engine
    del state
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": launched, "want": want}


def mesh_session(mm, rank: int) -> dict:
    """A chat session's three turns through the batching engine's lockstep
    turns (``submit_turn``, ``POST /chat`` under a mesh) at TP 2 on the 8B
    geometry, depth 4, f32 weights and the bf16 cache: each turn's tokens
    and prefilled count equal to the unsharded session's on rank 0; per turn
    and rank B6 once a layer for the delta, B2 = B3 once a layer and decode
    step; decode ms a step from the difference of turns 3 (2 x MESH_STEPS)
    and 2 (MESH_STEPS), both prefilling a delta of len(MESH_TAIL).  Rank 0
    times the unsharded session first, while rank 1 waits at a barrier."""
    import torch
    import torch.distributed as dist

    from gvl_tpu_torch.entry import flagship_config
    from gvl_tpu_torch.models.qwen3 import init_params
    from gvl_tpu_torch.models.session import Qwen3ChatSession
    from gvl_tpu_torch.serving import ContinuousBatchingEngine

    dev = mm.device
    cfg = flagship_config()
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(MESH_SEED),
                       dtype=torch.float32, device=dev)
    prompt = mesh_prompt(cfg).tolist()
    steps = (MESH_STEPS, MESH_STEPS, 2 * MESH_STEPS)

    def timed(run):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - start)

    def turns(run_turn) -> list:
        """(tokens, prefilled, ms, launches) of each turn, the transcript
        growing by the answer and MESH_TAIL."""
        rows, ids = [], prompt
        for i, n in enumerate(steps):
            if i:
                ids = ids + rows[-1][0] + MESH_TAIL
            reset_launches()
            (tokens, prefilled), ms = timed(lambda: run_turn(ids, n))
            rows.append((tokens, prefilled, ms, kernel_launches()))
        return rows

    out = {}
    dist.barrier()
    if rank == 0:
        alone = Qwen3ChatSession(cfg, full, eos_token_id=-1, device=dev)

        def alone_turn(ids, n):
            return alone.generate(ids, max_new_tokens=n, temperature=0.0), \
                alone.last_ingested

        with uncounted():
            alone_turn(prompt[:16], 2)
            alone.reset()
            want = turns(alone_turn)
        out.update(alone_turn_ms=[row[2] for row in want],
                   alone_decode_ms=(want[2][2] - want[1][2]) / MESH_STEPS)
        del alone
        torch.cuda.empty_cache()
    dist.barrier()
    engine = ContinuousBatchingEngine(cfg, full, eos_token_id=-1, num_slots=2, device=dev,
                                      mesh=mm)

    def lockstep_turn(ids, n):
        turn = engine.submit_turn("s", ids, n) if rank == 0 else None
        engine.step()
        if rank != 0:
            return [], 0
        if turn.error is not None:
            raise AssertionError(f"mesh session: {turn.error}")
        return turn.tokens, turn.prefilled

    # one turn first: lazy kernel loads, allocator growth
    with uncounted():
        lockstep_turn(prompt[:16], 2)
    got = turns(lockstep_turn)
    if list(engine.sessions) != ["s"]:
        raise AssertionError(f"mesh session: table {list(engine.sessions)}")
    launched = {}
    for i, (_, _, _, launches) in enumerate(got):
        expected = {"chunk_attention": cfg.num_layers,
                    "decode_attention": cfg.num_layers * steps[i],
                    "cache_append": cfg.num_layers * steps[i]}
        check_implied(f"mesh session turn {i + 1}", launches, expected)
        for k, v in launches.items():
            launched[k] = launched.get(k, 0) + v
    out.update(turn_ms=[row[2] for row in got],
               decode_ms=(got[2][2] - got[1][2]) / MESH_STEPS,
               launches_per_turn=[{k: v for k, v in row[3].items() if v} for row in got],
               launches=launched)
    del engine
    if rank == 0:
        same = [g[:2] == w[:2] for g, w in zip(got, want)]
        rank_log(rank, f"session TP 2 (8B geometry depth {cfg.num_layers}, f32 weights, "
                 f"bf16 cache): 3 lockstep turns, tokens and prefilled "
                 f"{[g[1] for g in got]} equal to the unsharded session's {same}; turn ms "
                 f"{[round(r[2], 3) for r in got]} against {[round(r[2], 3) for r in want]}; "
                 f"decode {out['decode_ms']:.3f} ms/step against "
                 f"{out['alone_decode_ms']:.3f} unsharded; launches a turn "
                 f"{out['launches_per_turn']}")
        if not all(same) or got[1][1] != len(MESH_TAIL):
            raise AssertionError("mesh session: the TP 2 turns differ from the unsharded "
                                 "session's")
    else:
        rank_log(rank, f"session TP 2: turn ms {[round(r[2], 3) for r in got]}, decode "
                 f"{out['decode_ms']:.3f} ms/step; launches a turn {out['launches_per_turn']}")
    del full
    torch.cuda.empty_cache()
    return out


def mesh_failures(mm, rank: int, prompts, want) -> dict:
    """Failures at 2 x 1 on the QA model (QA_SLOTS slots): the third
    request's prefill fails on its slot's replica only (rank 1: rank 0
    learns it from the admission's gather), which fails that request alone
    on both ranks; then, with rank 0's EngineServer driving and rank 1
    following, a decode step fails on both ranks once two slots are live:
    the live requests fail on both ranks, and the next requests give the
    unsharded engine's answers (``want``, rank 0's)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
    from gvl_tpu_torch.serving import ContinuousBatchingEngine, EngineServer
    from gvl_tpu_torch.serving.engine_server import EngineError
    from gvl_tpu_torch.training.qa_lm_train import load_qa_lm

    dev = mm.device
    cfg, state = load_qa_lm(QA_CKPT, device=dev)
    engine = ContinuousBatchingEngine(cfg, state, eos_token_id=EOS_ID, num_slots=QA_SLOTS,
                                      device=dev, mesh=mm)
    real, calls = engine._prefill, []

    def flaky(slot, delta):
        calls.append(slot)
        if len(calls) == 3 and engine._owns(slot):
            raise RuntimeError("injected prefill error")
        return real(slot, delta)

    engine._prefill = flaky
    first, second = prompts[:4], prompts[4:8]
    with uncounted():
        ids = [engine.submit(p, QA_MAX_NEW) for p in first]
        results = engine.run()
        after = engine.generate_many(second, QA_MAX_NEW)
    prefill_failed = [engine._requests[i].error is not None for i in ids]
    out = {"prefill_failed": prefill_failed}
    tripped = []

    def trip(module, args):
        if not tripped and sum(r is not None for r in engine._slot_req) >= 2:
            tripped.append(1)
            raise RuntimeError("injected device error")

    engine.model.register_forward_pre_hook(trip)
    with uncounted():
        if rank == 0:
            server = EngineServer(engine)

            def generate(prompt):
                try:
                    return server.generate(prompt, QA_MAX_NEW)
                except EngineError as exc:
                    return str(exc)

            try:
                with ThreadPoolExecutor(4) as pool:
                    streams = list(pool.map(generate, first))
                with ThreadPoolExecutor(4) as pool:
                    served = list(pool.map(generate, second))
            finally:
                server.shutdown()
                engine.release_followers()
        else:
            engine.follow()
    out["decode_failed"] = sorted(i for i, r in engine._requests.items() if r.error
                                  and "injected device error" in r.error)
    out["tripped"] = len(tripped)
    if rank == 0:
        kept = [results[i] == w for i, w, bad in zip(ids, want, prefill_failed) if not bad]
        failed = [isinstance(s, str) for s in streams]
        ok = (prefill_failed == [False, False, True, False] and all(kept)
              and after == want[4:8] and tripped == [1] and any(failed)
              and all(s == w for s, w, f in zip(streams, want, failed) if not f)
              and served == want[4:8] and len(out["decode_failed"]) == sum(failed))
        rank_log(rank, f"failures at 2 x 1: the prefill failed on rank 1 only fails its "
                 f"request alone ({prefill_failed}), the other answers equal the unsharded "
                 f"engine's {sum(kept)}/3, the run after {after == want[4:8]}; a decode "
                 f"step failed on both ranks: {sum(failed)} live stream(s) failed, the next "
                 f"4 answers equal the unsharded engine's {served == want[4:8]}")
        if not ok:
            raise AssertionError("mesh failures: not isolated as the unsharded engine "
                                 "isolates them")
    del engine, state
    torch.cuda.empty_cache()
    return out


def mesh_ring(mm, rank: int) -> dict:
    """Ring attention over the data group of two ranks at MESH_RING_SHAPE
    bf16, causal and not: output and gradients against f32 full attention,
    beside the plain bf16 path and B1; ms per call."""
    import torch

    from gvl_tpu_torch.ops.attention import attention_reference, flash_attention
    from gvl_tpu_torch.ops.ring_attention import ring_attention
    from gvl_tpu_torch.parallel.collectives import all_gather_cat

    dev = mm.device
    b, h, s, d = MESH_RING_SHAPE
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    q, k, v, g = (torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16()
                  for _ in range(4))
    half = s // 2
    mine = slice(rank * half, (rank + 1) * half)
    rows = {}
    for causal in (True, False):
        parts = [x[:, :, mine].detach().clone().requires_grad_() for x in (q, k, v)]

        def ring():
            return ring_attention(*parts, mm, axis_name="data", causal=causal)

        out = ring()
        out.backward(g[:, :, mine])
        whole = [all_gather_cat(t.detach(), 2, mm.data_group)
                 for t in (out, *(p.grad for p in parts))]
        fwd_ms = time_ms(ring, iters=3)

        def ring_step():
            for p in parts:
                p.grad = None
            ring().backward(g[:, :, mine])

        step_ms = time_ms(ring_step, iters=3)
        row = {"fwd_ms": fwd_ms, "fwd_bwd_ms": step_ms}
        if rank == 0:
            with uncounted():
                def full(dtype):
                    xs = [x.detach().to(dtype).requires_grad_() for x in (q, k, v)]
                    o = attention_reference(*xs, causal=causal)
                    o.backward(g.to(dtype))
                    return [o.detach(), *(x.grad for x in xs)]

                truth, plain = full(torch.float32), full(torch.bfloat16)
                b1 = flash_attention(q, k, v, causal=causal)
                row["plain_ms"] = time_ms(lambda: attention_reference(q, k, v, causal=causal),
                                          iters=3)
                row["b1_ms"] = time_ms(lambda: flash_attention(q, k, v, causal=causal),
                                       iters=3)
            names = ("out", "dq", "dk", "dv")
            row["ring_err"] = {n: rel_l2(a, t) for n, a, t in zip(names, whole, truth)}
            row["plain_err"] = {n: rel_l2(a, t) for n, a, t in zip(names, plain, truth)}
            row["b1_err"] = rel_l2(b1, truth[0])
            limit = {n: max(MESH_RING_RATIO * row["plain_err"][n], MESH_RING_FLOOR)
                     for n in names}
            ok = (all(row["ring_err"][n] <= limit[n] for n in names)
                  and row["b1_err"] <= limit["out"])
            rank_log(rank, f"ring {'causal' if causal else 'full'} {list(MESH_RING_SHAPE)} "
                     f"bf16 over 2 ranks: relative L2 against f32 full attention, ring "
                     + ", ".join(f"{n} {row['ring_err'][n]:.2e}" for n in names)
                     + "; plain bf16 " + ", ".join(f"{n} {row['plain_err'][n]:.2e}"
                                                  for n in names)
                     + f"; B1 out {row['b1_err']:.2e} (limit {MESH_RING_RATIO}x the plain "
                     f"path's, floor {MESH_RING_FLOOR:.2e}); ms per call: ring forward "
                     f"{fwd_ms:.2f}, forward + backward {step_ms:.2f}, plain full "
                     f"{row['plain_ms']:.2f}, B1 full {row['b1_ms']:.3f} "
                     f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError("mesh ring: ring attention strays from full attention")
        rows["causal" if causal else "full"] = row
        del parts, out, whole
    del q, k, v, g
    torch.cuda.empty_cache()
    return rows


def same_detections(got, want) -> bool:
    """Equal counts per frame and concept, scores within SCORE_TOL, boxes
    within a pixel and areas within MASK_FLIP_SHARE (a mask cell that
    rounds across the threshold when a rank segments half the frames)."""
    for fg, fw in zip(got, want):
        for cg, cw in zip(fg, fw):
            if len(cg) != len(cw):
                return False
            for a, b in zip(cg, cw):
                ma, mb = a["mask"], b["mask"]
                boxes = (ma.bbox.x_min, ma.bbox.y_min, ma.bbox.x_max, ma.bbox.y_max,
                         mb.bbox.x_min, mb.bbox.y_min, mb.bbox.x_max, mb.bbox.y_max)
                if (abs(ma.confidence - mb.confidence) > SCORE_TOL
                        or max(abs(boxes[i] - boxes[i + 4]) for i in range(4)) > 1
                        or abs(ma.area_pixels - mb.area_pixels)
                        > MASK_FLIP_SHARE * max(mb.area_pixels, 1)):
                    return False
    return len(got) == len(want)


def mesh_segmenter(mm, rank: int) -> dict:
    """The segmenter at its trained geometry (phase 11's seeded weights) on
    MESH_FRAMES frames x 4 concepts split over data 2."""
    import torch

    from gvl_tpu_torch.perception import encoders as E
    from gvl_tpu_torch.perception.segmenter import SAMConfig, TorchSegmenterBackend

    dev = mm.device
    backend = TorchSegmenterBackend(
        SAMConfig(), generator=torch.Generator(device=dev).manual_seed(PERCEPTION_SEED),
        device=dev, mesh=mm)
    frames = E.gameplay_frames(MESH_FRAMES, seed=PERCEPTION_SEED)
    concepts, index = list(E.CONCEPTS), list(range(MESH_FRAMES))
    with uncounted():
        backend(frames, concepts, index)
    reset_launches()
    start = time.perf_counter()
    got = backend(frames, concepts, index)
    seconds = time.perf_counter() - start
    launches = kernel_launches()
    if not launches["flash_attention"]:
        raise AssertionError("mesh segmenter: no flash_attention launch")
    row = {"ms": 1e3 * seconds, "launches": {k: v for k, v in launches.items() if v},
           "detections": sum(len(c) for f in got for c in f)}
    if rank == 0:
        backend.mesh = None
        with uncounted():
            start = time.perf_counter()
            want = backend(frames, concepts, index)
            row["alone_ms"] = 1e3 * (time.perf_counter() - start)
        ok = same_detections(got, want)
        rank_log(rank, f"segmenter: {MESH_FRAMES} frames x {len(concepts)} concepts over "
                 f"data 2: {row['detections']} detections, "
                 f"{'equal to' if ok else 'DIFFERENT FROM'} one rank's; {row['ms']:.1f} ms "
                 f"against {row['alone_ms']:.1f} on one rank; launches {row['launches']}")
        if not ok:
            raise AssertionError("mesh segmenter: data-parallel detections differ")
    del backend
    torch.cuda.empty_cache()
    return row


def mesh_siglip(mm, rank: int) -> dict:
    """The fused W8A8 so400m tower (phase 9's seeded weights), padded heads
    (B7, B8, B9) and packed heads (B7, B8, B10), on MESH_FRAMES frames split
    over data 2: pooled embeddings against one rank's."""
    import numpy as np
    import torch

    from gvl_tpu_torch.perception.semantic import (
        FusedSigLIPBackend,
        NaFlexConfig,
        SigLIPSemanticEncoder,
        calibration_pixels,
    )

    dev = mm.device
    config = NaFlexConfig(quant_fused=True)
    encoder = SigLIPSemanticEncoder.with_random_tower(config, device=dev, seed=SEMANTIC_SEED,
                                                      mesh=mm)
    tower = encoder.backend.tower
    packed = SigLIPSemanticEncoder(config, backend=FusedSigLIPBackend(
        tower, calib_pixels=calibration_pixels(config, tower.config.image_size, dev),
        pool_strategy=config.pool_strategy, packed_attention=True, mesh=mm))
    frames = semantic_inputs()[0][:MESH_FRAMES]
    layers = tower.config.num_layers
    rows = {}
    for name, enc, head in (("padded", encoder, "attention_fused_qkv"),
                            ("packed", packed, "attention_packed_multihead")):
        with uncounted():
            enc.encode_images_batch(frames)
        reset_launches()
        got = enc.encode_images_batch(frames)
        torch.cuda.synchronize()
        launches = kernel_launches()
        check_implied(f"mesh siglip {name}", launches, dict(FUSED_LAUNCHES, **{head: layers}))
        row = {"launches": {k: v for k, v in launches.items() if v}}
        if rank == 0:
            enc.backend.mesh = None
            with uncounted():
                want = enc.encode_images_batch(frames)
            enc.backend.mesh = mm
            cos = cosines(got, want)
            row["cos_min"] = float(cos.min())
            ok = bool(np.isfinite(got).all()) and got.shape == want.shape and cos.min() >= COS_DP
            rank_log(rank, f"siglip {name}: {len(frames)} frames over data 2, pooled cosine "
                     f"to one rank's min {cos.min():.7f} (limit {COS_DP}); launches "
                     f"{row['launches']} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"mesh siglip {name}: data-parallel embeddings differ")
        rows[name] = row
    del encoder, packed, tower
    torch.cuda.empty_cache()
    return rows


def mesh_process(rank: int, store: str, workdir: str) -> int:
    """One rank of phase 20's gloo world (both ranks on cuda:0): each part
    in turn, in lockstep; writes its numbers to ``workdir/rank{rank}.json``."""
    import torch

    from gvl_tpu_torch.ops import _build
    from gvl_tpu_torch.parallel import collectives
    from gvl_tpu_torch.parallel.mesh import (
        MeshManager,
        build_mesh,
        init_distributed,
        shutdown_distributed,
    )

    faulthandler.dump_traceback_later(MESH_RANK_S, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(init_method=store, world_size=2, rank=rank, local_rank=rank,
                     local_world_size=2, device="cuda")
    _build.library()
    collectives.set_timing(True)
    tp, dp = MeshManager(build_mesh(1, 2)), MeshManager(build_mesh(2, 1))
    for mm in (tp, dp):
        if mm.backend != "gloo" or mm.device != torch.device("cuda", 0):
            raise AssertionError(f"mesh: {mm.describe()}: ranks sharing a card take gloo "
                                 "on cuda:0")
    rank_log(rank, f"{tp.describe()}; {dp.describe()}")
    prompts = json.loads(Path(workdir, "prompts.json").read_text())
    torch.cuda.reset_peak_memory_stats()
    out = {"describe": [tp.describe(), dp.describe()]}
    out["tp"] = mesh_tp(tp, rank)
    out["qa"] = mesh_qa({"2x1": dp, "1x2": tp}, rank, prompts)
    out["session"] = mesh_session(tp, rank)
    out["failures"] = mesh_failures(dp, rank, prompts, out["qa"].pop("want"))
    out["ring"] = mesh_ring(dp, rank)
    out["segmenter"] = mesh_segmenter(dp, rank)
    out["siglip"] = mesh_siglip(dp, rank)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    Path(workdir, f"rank{rank}.json").write_text(json.dumps(out))
    rank_log(rank, f"allocator peak {out['peak_gib']:.2f} GiB")
    shutdown_distributed()
    faulthandler.cancel_dump_traceback_later()
    return 0


def gloo_world(workdir: Path) -> list[dict]:
    """Phase 20 (b): two processes joined over gloo, both on cuda:0; fails
    as soon as one of them does (the other is stopped)."""
    store = f"file://{workdir / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.mesh_process("
         f"{rank}, {store!r}, {str(workdir)!r}))"], cwd=REPO) for rank in (0, 1)]
    deadline = time.time() + MESH_RANK_S + 30
    try:
        while any(p.poll() is None for p in procs):
            failed = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.time() > deadline:
                raise AssertionError(f"mesh: rank {failed or 'time'} of the gloo world "
                                     f"failed (exit codes {[p.poll() for p in procs]})")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads((workdir / f"rank{rank}.json").read_text()) for rank in (0, 1)]


class Deploy:
    """``torchrun --nproc-per-node 2 -m gvl_tpu_torch.scripts.deploy_api
    --tp 2`` on the QA model, as processes (output in ``log``)."""

    def __init__(self, workdir: Path):
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.log = workdir / "deploy.log"
        self.sink = open(self.log, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "gvl_tpu_torch.scripts.deploy_api", "--tp", "2",
             "--port", str(self.port), "--num-slots", str(QA_SLOTS),
             "--llm-checkpoint", str(QA_CKPT)],
            cwd=REPO, stdout=self.sink, stderr=subprocess.STDOUT, start_new_session=True)

    def ready(self, deadline: float) -> int:
        """The serving rank's pid, once it listens."""
        while time.time() < deadline and self.proc.poll() is None:
            found = re.search(r"serving on 127\.0\.0\.1:\d+ \(pid (\d+)\)",
                              self.log.read_text())
            if found:
                return int(found.group(1))
            time.sleep(0.2)
        raise AssertionError(f"mesh deploy: not serving ({self.tail()})")

    def tail(self) -> str:
        return self.log.read_text()[-2000:]

    def stop(self) -> None:
        import os
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self.sink.close()


def stream_times(port: int, body: dict, times: list) -> None:
    """Appends to ``times`` the arrival time (``perf_counter``) of each
    token of ``POST /generate/stream`` as it comes."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/generate/stream", body=json.dumps(body))
        resp = conn.getresponse()
        while line := resp.readline():
            if line.strip():
                times.append(time.perf_counter())
    finally:
        conn.close()


def mesh_deploy(dev, deploy: Deploy, prompts) -> None:
    """4 concurrent POST /generate against the unsharded generate_many; two
    sessions of two POST /chat turns each against the unsharded session on
    the card (turn 2 prefills only its delta); how long a running /generate
    stream stalls while a chat turn runs in the engine's step; then SIGTERM
    to the serving rank, which releases its follower: both exit 0."""
    import os
    import signal
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
    from gvl_tpu_torch.models.session import Qwen3ChatSession
    from gvl_tpu_torch.serving import ContinuousBatchingEngine
    from gvl_tpu_torch.training.qa_lm_train import load_qa_lm

    four = prompts[:4]
    cfg, state = load_qa_lm(QA_CKPT, device=dev)
    with uncounted():
        want = ContinuousBatchingEngine(cfg, state, eos_token_id=EOS_ID, num_slots=QA_SLOTS,
                                        device=dev).generate_many(four, QA_MAX_NEW)
        # the sessions' turns, unsharded: (tokens, prefilled, ms) of each
        want_chat = {}
        for sid, first in (("s4", prompts[4]), ("s5", prompts[5])):
            session = Qwen3ChatSession(cfg, state, eos_token_id=EOS_ID, device=dev)
            session.generate(first[:64], max_new_tokens=2, temperature=0.0)  # warm
            session.reset()
            rows, ids = [], first
            for turn in range(2):
                if turn:
                    ids = ids + rows[-1][0] + follow_up("Which event came last?")
                torch.cuda.synchronize()
                start = time.perf_counter()
                tokens = session.generate(ids, max_new_tokens=QA_MAX_NEW, temperature=0.0)
                torch.cuda.synchronize()
                rows.append((tokens, session.last_ingested,
                             1e3 * (time.perf_counter() - start)))
            want_chat[sid] = rows
            del session
    del state
    torch.cuda.empty_cache()
    pid = deploy.ready(time.time() + MESH_DEPLOY_S)
    start = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        replies = list(pool.map(lambda p: http_json(deploy.port, "POST", "/generate", {
            "prompt_ids": p, "max_new_tokens": QA_MAX_NEW}), four))
    seconds = time.perf_counter() - start
    # C18: the sessions' turns, in lockstep on both ranks
    got_chat, chat_ok = {}, True
    for sid, first in (("s4", prompts[4]), ("s5", prompts[5])):
        rows, ids = [], first
        for turn in range(2):
            if turn:
                ids = ids + rows[-1][0] + follow_up("Which event came last?")
            start_turn = time.perf_counter()
            status, reply = http_json(deploy.port, "POST", "/chat", {
                "session_id": sid, "prompt_ids": ids, "max_new_tokens": QA_MAX_NEW})
            ms = 1e3 * (time.perf_counter() - start_turn)
            if status != 200:
                raise AssertionError(f"mesh deploy: POST /chat answered {status}: {reply}")
            rows.append((reply["tokens"], reply["prefilled"], ms))
        got_chat[sid] = rows
        delta = len(follow_up("Which event came last?"))
        chat_ok &= ([r[:2] for r in rows] == [w[:2] for w in want_chat[sid]]
                    and rows[1][1] == delta)
    # the price of lockstep: a stream waits while a chat turn runs in the step
    times, stream_done = [], threading.Event()

    def stream():
        try:
            stream_times(deploy.port, {"prompt_ids": prompts[6],
                                       "max_new_tokens": QA_MAX_NEW}, times)
        finally:
            stream_done.set()

    reader = threading.Thread(target=stream)
    reader.start()
    # the chat turn once the stream's first token has come (its request is
    # admitted and decoding)
    while not times and not stream_done.wait(0.001):
        pass
    turn_at = time.perf_counter()
    status, _ = http_json(deploy.port, "POST", "/chat", {
        "session_id": "stall", "prompt_ids": prompts[7], "max_new_tokens": QA_MAX_NEW})
    turn_end = time.perf_counter()
    reader.join(timeout=300)
    gaps = [b - a for a, b in zip(times, times[1:])]
    during = [b - a for a, b in zip(times, times[1:]) if b > turn_at and a < turn_end]
    typical = sorted(gaps)[len(gaps) // 2] if gaps else None
    stall = (f"longest gap {1e3 * max(during):.1f} ms while the {1e3 * (turn_end - turn_at):.1f}"
             f" ms turn ran, median gap {1e3 * typical:.1f} ms over {len(times)} tokens"
             if during and typical is not None else
             f"not measured: the stream's {len(times)} tokens ended before the turn ran")
    os.kill(pid, signal.SIGTERM)
    rc = deploy.proc.wait(timeout=60)
    same = sum(r[0] == 200 and r[1].get("tokens") == w for r, w in zip(replies, want))
    described = re.search(r"serving over (.*)", deploy.log.read_text())
    log("mesh", f"deploy_api --tp 2 under torchrun ({described.group(1) if described else '?'})"
        f": 4 concurrent POST /generate in {seconds:.2f} s, tokens equal to the unsharded "
        f"generate_many {same}/4; SIGTERM to rank 0: torchrun exit {rc}")
    for sid, rows in got_chat.items():
        log("mesh", f"deploy POST /chat session {sid}: prefilled {[r[1] for r in rows]} "
            f"(unsharded {[w[1] for w in want_chat[sid]]}), tokens equal "
            f"{[r[0] == w[0] for r, w in zip(rows, want_chat[sid])]}; turn ms (HTTP, TP 2) "
            f"{[round(r[2], 1) for r in rows]} against the unsharded session's "
            f"{[round(w[2], 1) for w in want_chat[sid]]}; {nvidia_smi()}")
    log("mesh", f"deploy: a /generate stream during a POST /chat turn (status {status}): "
        f"{stall}; {nvidia_smi()}")
    if same != 4 or rc != 0 or not chat_ok or status != 200:
        raise AssertionError(f"mesh deploy: {same}/4 equal, chat equal {chat_ok}, exit {rc} "
                             f"({deploy.tail()})")


def run_mesh(dev, prompts):
    """Phase 20 (the module docstring): (a) the NCCL world of one rank, (b)
    the gloo world of two processes on the card, and deploy_api --tp 2
    under torchrun (started first, served last)."""
    import tempfile

    start = time.perf_counter()
    launched = {}

    def add(counts):
        for k, v in counts.items():
            launched[k] = launched.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        workdir = Path(tmp)
        (workdir / "prompts.json").write_text(json.dumps(prompts[:MESH_QA_PROMPTS]))
        deploy = Deploy(workdir)
        try:
            add(mesh_nccl(dev))
            ranks = gloo_world(workdir)
            for r, out in enumerate(ranks):
                for part in ("tp", "qa", "session"):
                    add(out[part]["launches"])
                add(out["segmenter"]["launches"])
                for row in out["siglip"].values():
                    add(row["launches"])
                tp_rows = out["tp"]["rows"]
                log("mesh", f"(b) rank {r}: TP 2 decode ms/step "
                    + ", ".join(f"{n} {row['decode_ms']:.3f} (collectives "
                                f"{row['collective_ms']:.3f})" for n, row in tp_rows.items())
                    + f"; allocator peak {out['peak_gib']:.2f} GiB; {nvidia_smi()}; gloo "
                    "stages every collective through the host: these times measure the "
                    "sharded code on one card, not a multi-card deployment")
                log("mesh", f"(b) rank {r}: the 8B TP 2 session's decode "
                    f"{out['session']['decode_ms']:.3f} ms/step"
                    + (f" against {out['session']['alone_decode_ms']:.3f} for the unsharded "
                       "session" if r == 0 else "")
                    + f", turns {[round(t, 3) for t in out['session']['turn_ms']]} ms; "
                    f"{nvidia_smi()}")
            agreed = [out["failures"] for out in ranks]
            if agreed[0] != agreed[1]:
                raise AssertionError(f"mesh failures: the ranks disagree: {agreed}")
            mesh_deploy(dev, deploy, prompts)
        finally:
            deploy.stop()
    elapsed = time.perf_counter() - start
    log("mesh", f"phase 20 in {elapsed:.1f} s (budget {MESH_BUDGET_S} s)")
    if elapsed > MESH_BUDGET_S:
        raise AssertionError(f"mesh: phase 20 took {elapsed:.1f} s, over its {MESH_BUDGET_S} s")
    return {k: launched.get(k, 0) for k in kernel_launches()}


def surface_decoder(dev) -> dict:
    """Phase 21 (a): the decoder-family stack at the 8B layer geometry, kernel
    path against the plain path (``nn.layers.plain_attention``) and both
    against an f32 plain evaluation of the same weights: forward, then
    forward and backward; B1's launches as implied.  Then a cross-attention
    call and a ``kv_len``-masked block at small shapes."""
    import torch

    from gvl_tpu_torch.nn.layers import (
        Attention,
        TransformerBlock,
        TransformerStack,
        init_state,
        load_module,
        plain_attention,
    )
    from gvl_tpu_torch.ops.attention import flash_attention
    from gvl_tpu_torch.utils.profiler import stage_scope

    geometry = dict(SURFACE_GEOMETRY)
    dim = geometry.pop("dim")
    heads, ffn = geometry.pop("num_heads"), geometry.pop("intermediate_dim")

    def build():
        with torch.device("meta"):
            return TransformerStack(SURFACE_LAYERS, dim, heads, ffn, **geometry)

    gen = torch.Generator(device=dev).manual_seed(SURFACE_SEED)
    model = build()
    state = init_state(model, gen, dev)
    f32 = load_module(build(), state, dev)
    bf16 = load_module(model, {k: v.bfloat16() for k, v in state.items()}, dev)
    del state
    x = torch.randn(1, SURFACE_SEQ, dim, generator=gen, device=dev)
    g = torch.randn(1, SURFACE_SEQ, dim, generator=gen, device=dev)

    def run(net, inp, plain: bool, backward: bool):
        """(output, [d input, *d parameters]) of one call."""
        net.zero_grad(set_to_none=True)
        leaf = inp.clone().requires_grad_(backward)
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_attention())
            if not backward:
                stack.enter_context(torch.inference_mode())
            out = net(leaf)
            if backward:
                (out.float() * g).sum().backward()
        torch.cuda.synchronize()
        grads = ([leaf.grad] + [p.grad for p in net.parameters()]) if backward else []
        return out.detach(), grads

    def flat(grads):
        return torch.cat([t.float().flatten() for t in grads])

    result, launches = {}, {}
    xb = x.bfloat16()
    for backward in (False, True):
        what = "forward + backward" if backward else "forward"
        reset_launches()
        with stage_scope("decoder_stack"):
            out_k, grads_k = run(bf16, xb, False, backward)
        counts = served_launches("surface", ("flash_attention",))
        want = SURFACE_LAYERS * (2 if backward else 1)   # + the blockwise delta recompute
        if counts["flash_attention"] != want or sum(counts.values()) != want:
            raise AssertionError(f"surface: decoder stack {what}: launches {counts}, "
                                 f"implied flash_attention {want} and nothing else")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        with uncounted():
            before = flash_attention.launches
            out_p, grads_p = run(bf16, xb, True, backward)
            if flash_attention.launches != before:
                raise AssertionError("surface: the plain path launched B1")
            out_t, grads_t = run(f32, x, True, backward)
        pairs = [("out", out_k, out_p, out_t)]
        if backward:
            pairs += [("d input", grads_k[0], grads_p[0], grads_t[0]),
                      ("d parameters", flat(grads_k[1:]), flat(grads_p[1:]),
                       flat(grads_t[1:]))]
        for name, kern, plain, truth in pairs:
            err_k, err_p = rel_l2(kern, truth), rel_l2(plain, truth)
            limit = max(MESH_RING_RATIO * err_p, MESH_RING_FLOOR)
            ok = bool(torch.isfinite(kern).all()) and err_k <= limit
            log("surface", f"decoder stack {what}, {name}: relative L2 against f32, kernel "
                f"path {err_k:.3e}, plain bf16 path {err_p:.3e} (limit {limit:.3e}) "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"surface: decoder stack {what} {name}: kernel path "
                                     f"{err_k} against f32, limit {limit}")
            result[f"{what} {name}"] = (err_k, err_p)
        with uncounted():
            for plain in (False, True):
                ms = time_ms(lambda: run(bf16, xb, plain, backward), iters=3)
                result[f"{what} {'plain' if plain else 'kernel'} ms"] = ms
        log("surface", f"decoder stack {what} ms: kernel path "
            f"{result[f'{what} kernel ms']:.2f}, plain path {result[f'{what} plain ms']:.2f}; "
            f"{nvidia_smi()}")
        del out_k, grads_k, out_p, grads_p, out_t, grads_t
    with uncounted():   # the stage's name in a profile of one call
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with stage_scope("decoder_stack"):
                run(bf16, xb, False, False)
    names = {e.key for e in prof.key_averages()}
    if "decoder_stack" not in names:
        raise AssertionError("surface: stage_scope's range is missing from the profile")
    log("surface", "stage_scope 'decoder_stack' found in a torch.profiler trace of one call")
    del f32, bf16, x, g
    torch.cuda.empty_cache()

    # cross-attention (kv given: rope on q alone) and a kv_len-masked block
    gen = torch.Generator(device=dev).manual_seed(SURFACE_SEED + 1)
    small = [("cross-attention [1,200,512] over kv [1,300,512], GQA 8/2, rope, qk-norm",
              Attention(512, 8, num_kv_heads=2, rope=True, qk_norm=True),
              lambda m, a, b: m(a, b), 1),
             ("LayerNorm/GELU block [2,192,512], kv_len 150",
              TransformerBlock(512, 8, 1024),
              lambda m, a, b: m(a, kv_len=150), 1)]
    for what, module, call, implied in small:
        module = load_module(module, {k: v.bfloat16() for k, v in
                                      init_state(module, gen, dev).items()}, dev)
        a = torch.randn(2 if "block" in what else 1, 192 if "block" in what else 200, 512,
                        generator=gen, device=dev).bfloat16()
        b = torch.randn(1, 300, 512, generator=gen, device=dev).bfloat16()
        reset_launches()
        with torch.inference_mode():
            got = call(module, a, b)
        torch.cuda.synchronize()
        counts = served_launches("surface", ("flash_attention",))
        with uncounted(), plain_attention(), torch.inference_mode():
            want = call(module, a, b)
        err = assert_close(f"surface: {what}, kernel vs plain path", got, want, BF16_TOL)
        if counts["flash_attention"] != implied:
            raise AssertionError(f"surface: {what}: launches {counts}")
        launches["flash_attention"] += implied
        result[what] = err
    return {"launches": launches, "rows": result}


def surface_int8_tower(dev) -> dict:
    """Phase 21 (b): the so400m fused tower with ``int8_attention`` (B9 in its
    int8_scores mode) on 8 frames at 384 px, phase 9's seeded weights,
    against its plain path; beside the tower without it; images/s of both.
    Then ``encode_with_context`` on the same encoder against two
    ``encode_masked_regions`` calls."""
    import numpy as np
    import torch

    from gvl_tpu_torch.perception.semantic import NaFlexConfig, SigLIPSemanticEncoder

    encoder = SigLIPSemanticEncoder.with_random_tower(NaFlexConfig(quant_fused=True),
                                                      device=dev, seed=SEMANTIC_SEED)
    backend = encoder.backend
    cfg = backend.config
    frames, frame, masks = semantic_inputs()
    batch = np.stack([encoder.region_extractor.prepare(f)[0] for f in frames])
    pixels = backend.normalize(batch, torch.bfloat16)
    launches = {}
    reset_launches()
    got = fused_pooled(backend, pixels, int8_attention=True)
    counts = served_launches("surface", ("w8a8_matmul", "ln_quant", "attention_fused_qkv"))
    want_counts = dict(FUSED_LAUNCHES, attention_fused_qkv=cfg.num_layers)
    if any(counts[k] != v for k, v in want_counts.items()) or counts[
            "attention_packed_multihead"]:
        raise AssertionError(f"surface: int8_attention tower launches {counts}, one forward "
                             f"launches {want_counts}")
    launches.update({k: v for k, v in counts.items() if v})
    with uncounted():
        cos = check_cosine("surface", f"so400m int8_attention tower ({len(frames)} frames): "
                           "kernel path vs plain path", got,
                           fused_pooled(backend, pixels, int8_attention=True, kernels=False),
                           COS_KERNEL_PLAIN)
        bf16_scores = fused_pooled(backend, pixels)
        against = cosines(got, bf16_scores)
        _, s8 = timed_encode(lambda: fused_pooled(backend, pixels, int8_attention=True))
        _, s = timed_encode(lambda: fused_pooled(backend, pixels))
    log("surface", f"int8_attention against int8_attention=False, same tree: pooled cosine "
        f"min {against.min():.6f} mean {against.mean():.6f} (recorded, no limit); "
        f"images/s {len(frames) / s8:.1f} with int8_attention, {len(frames) / s:.1f} "
        f"without ({1e3 * s8:.2f} / {1e3 * s:.2f} ms per 8 frames); {nvidia_smi()}")

    entity, mask = masks[0]
    reset_launches()
    region, context = encoder.encode_with_context(frame, mask)
    counts = served_launches("surface", ("w8a8_matmul", "ln_quant", "attention_fused_qkv"))
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    with uncounted():
        import scipy.ndimage as ndi

        ring = ndi.binary_dilation(mask, iterations=max(1, 50 // 3)) & ~mask
        want = [encoder.encode_masked_regions(frame, [(name, m)])[0]
                for name, m in (("region", mask), ("context", ring))]
    same = all(np.array_equal(a.embedding, b.embedding) and a.original_bbox == b.original_bbox
               for a, b in zip((region, context), want))
    log("surface", f"encode_with_context ({entity}): region and context embeddings "
        f"{'equal to two encode_masked_regions calls: ok' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("surface: encode_with_context differs from its two region calls")
    del encoder, backend
    torch.cuda.empty_cache()
    return {"launches": launches, "cos_plain": cos, "images_per_s": (len(frames) / s8,
                                                                      len(frames) / s)}


def run_surface(dev) -> dict:
    """Phase 21 (the module docstring): the decoder-family nn blocks on B1,
    the fused tower's int8 attention on B9, encode_with_context, stage_scope
    and device_memory_stats; within ``SURFACE_BUDGET_S``."""
    import torch

    from gvl_tpu_torch.utils.profiler import device_memory_stats

    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    decoder = surface_decoder(dev)
    tower = surface_int8_tower(dev)
    stats = device_memory_stats()
    log("surface", f"device_memory_stats {stats}")
    if not (stats.get("bytes_in_use", 0) > 0 and stats.get("peak_bytes_in_use", 0) > 0
            and stats.get("bytes_limit", 0) >= stats["peak_bytes_in_use"]):
        raise AssertionError(f"surface: device_memory_stats {stats}")
    elapsed = time.perf_counter() - start
    log("surface", f"phase 21 in {elapsed:.1f} s (budget {SURFACE_BUDGET_S} s)")
    if elapsed > SURFACE_BUDGET_S:
        raise AssertionError(f"surface: phase 21 took {elapsed:.1f} s, over its "
                             f"{SURFACE_BUDGET_S} s")
    launched = {}
    for part in (decoder["launches"], tower["launches"]):
        for k, v in part.items():
            launched[k] = launched.get(k, 0) + v
    return {k: launched.get(k, 0) for k in kernel_launches()}


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
    log("device", f"gloo collectives on CUDA tensors in this PyTorch: {gloo_probe()} "
        "(the port stages CUDA tensors through the host on every gloo group)")

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
    torch.cuda.empty_cache()
    served.append(run_hf(dev))
    torch.cuda.empty_cache()
    train_launches, b1_per_step = run_train(dev)
    served.append(train_launches)
    torch.cuda.empty_cache()
    perception_launches, trainer_rows = run_perception_train(dev)
    served.append(perception_launches)
    torch.cuda.empty_cache()
    served.append(run_mesh(dev, prompts))
    torch.cuda.empty_cache()
    served.append(run_surface(dev))
    trainer_b1 = {row["name"]: row["b1_per_step"] for row in trainer_rows}
    launches = {name: sum(run.get(name, 0) for run in served) for name in served[0]}
    log("launches", f"served paths (phases 3-21): {launches}")
    missing = [name for name, n in launches.items() if n == 0 and name not in UNSERVED]
    if missing:
        raise AssertionError(f"kernels not launched on a served path: {missing}")
    for row in rows:
        row["launches"] = launches[row["name"]]
        for line in row.get("lines", []):
            if line["shape"].startswith("QA training"):
                line["launches_per_step"] = b1_per_step
            for trainer in ("VideoMAE", "byte ASR"):
                if line["shape"].startswith(f"{trainer} training"):
                    line["launches_per_step"] = trainer_b1[trainer]

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
