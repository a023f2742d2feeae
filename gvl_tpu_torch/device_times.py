"""Device-side kernel times and the device's busy share during decode and
during the fused SigLIP tower's forward.

    python -m gvl_tpu_torch.device_times [--only kernels|decode|semantic|perception]

Run from the repository root on a machine with one CUDA card.  CUDA events
around back-to-back calls of a small kernel measure the host's launch cost
as much as the kernel; this script reads the device's own kernel durations
from ``torch.profiler`` (CUPTI) instead:

1. each port kernel's device time per launch at the shapes the served models
   give it (QA prefill at 4096 tokens, the 8B prefill of 128 tokens, the
   bf16 so400m tower's attention and its MAP head, QA decode at 3072 live
   rows, one 8B cache row, a QA admission chunk of 2048 tokens, the 8B
   scan-layers decode of 4 slots);
2. for greedy decode of one held-out QA prompt (seed 1234) and of the 8B
   layer geometry at depth 4: wall time per step (host clock, no profiler),
   device kernel time per step (profiler), their ratio (the device's busy
   share) and the kernels that take the device time; for the QA model also
   the wall time per step with the decode write through the append kernel
   and through the scatter route, in 7 alternating rounds;
3. the same for a batched decode step of ``ContinuousBatchingEngine`` with
   4 slots, and for the step that admits the 4 prompts (chunk prefills):
   the QA model on 4 held-out prompts, and the 8B geometry with
   ``scan_layers`` on 4 random prompts;
4. the region semantic encoder's so400m fused W8A8 tower (random weights,
   seed 0): the device time per launch of the six fused kernels at its
   shapes, and for one forward at batch 8 (384 canvas) and at the region
   bucket of 16 (128 canvas), wall and device ms per batch, the busy share
   and the top device kernels; the bf16 tower beside it;
5. the ``qa_lm`` arm's perception encoders at their trained geometry with
   seeded random weights (:mod:`gvl_tpu_torch.perception.encoders`): the
   flash kernel's device time per launch at their attention shapes and at
   those of the gvp arms' models (the mini-SigLIP's towers, VideoMAE,
   HiCo's pool with head 176, whose call also counts the wrapper's pads,
   and head 192), and
   for one call of each encoder's entry point (the retriever on 128 texts,
   the segmenter on 32 frames x 4 concepts, the OCR engine on 8 HUD
   frames, event detection on 8 s, transcription of 4 windows of 6 s)
   wall ms, device ms, CUDA kernel launches, the busy share and the top
   device kernels.

Every decode profile also counts the device's kernel launches per step
(``device_launches_per_step``, CUDA kernel events in the profile) and its
memory copies and sets (``device_copies_per_step``).

``--only kernels``, ``decode``, ``semantic`` or ``perception`` runs part 1,
parts 2-3, part 4 or part 5 alone.  ``decode`` uses only what every slice of the port has, so
this file copied into a checkout of an earlier commit measures that commit
the same way.  It prints one JSON object as its last line.  The host's
cost per call of each kernel wrapper is ``launch_costs.py``'s, at the
repository root.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from gvl_tpu_torch import resolve_device

REPO = Path(__file__).resolve().parents[1]


def _device_us(prof) -> dict[str, float]:
    """Device microseconds per kernel name in a finished profile."""
    out: dict[str, float] = {}
    for event in prof.key_averages():
        us = getattr(event, "device_time_total", 0.0)
        if us:
            out[event.key] = out.get(event.key, 0.0) + us
    return out


def _launch_counts(prof) -> tuple[int, int]:
    """(kernel launches, memory copies and sets) in a finished profile of
    CUDA activity only."""
    kernels = copies = 0
    for event in prof.key_averages():
        if event.key.startswith(("Memcpy", "Memset")):
            copies += event.count
        elif getattr(event, "device_time_total", 0.0):
            kernels += event.count
    return kernels, copies


def kernel_device_ms(fn, names: tuple[str, ...], iters: int = 50) -> float | None:
    """Device ms per call of ``fn`` spent in CUDA kernels whose name holds
    one of ``names``; None when the profiler saw no device activity."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(t for key, t in _device_us(prof).items() if any(n in key for n in names))
    return us / 1e3 / iters if us else None


def _decode_run(engine, prompt_ids, steps: int, profiled: bool = False):
    """One greedy stream: (decode steps after the prefill, wall seconds of
    those steps, or the finished profile when ``profiled``)."""
    stream = engine.stream(prompt_ids, max_new_tokens=steps, temperature=0.0)
    next(stream)                           # prefill and the first token
    torch.cuda.synchronize()
    start = time.perf_counter()
    if profiled:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            n = 1 + sum(1 for _ in stream)
            torch.cuda.synchronize()
        return n, prof
    n = 1 + sum(1 for _ in stream)
    torch.cuda.synchronize()
    return n, time.perf_counter() - start


def decode_profile(engine, prompt_ids, steps: int) -> dict:
    """Wall and device time per greedy decode step after the prefill."""
    _decode_run(engine, prompt_ids, steps)         # warm-up
    n, wall = _decode_run(engine, prompt_ids, steps)
    _, prof = _decode_run(engine, prompt_ids, steps, profiled=True)
    per_kernel = _device_us(prof)
    device_ms = sum(per_kernel.values()) / 1e3 / n
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    launches, copies = _launch_counts(prof)
    return {
        "steps": n,
        "wall_ms_per_step": 1e3 * wall / n,
        "device_ms_per_step": device_ms,
        "busy_share": device_ms / (1e3 * wall / n),
        "device_launches_per_step": launches / n,
        "device_copies_per_step": copies / n,
        "top_kernels_ms_per_step": {k[:80]: v / 1e3 / n for k, v in top},
    }


def route_ab(engines: dict, prompt_ids, steps: int, rounds: int = 7) -> dict:
    """Wall ms per decode step of engines that differ in one route, run in
    turns (a, b, a, b, ...) in one process so that the host's drift falls
    on both alike; per round and the medians."""
    for engine in engines.values():
        _decode_run(engine, prompt_ids, steps)     # warm-up
    ms = {name: [] for name in engines}
    for _ in range(rounds):
        for name, engine in engines.items():
            n, wall = _decode_run(engine, prompt_ids, steps)
            ms[name].append(1e3 * wall / n)
    return {"rounds_ms_per_step": ms,
            "median_ms_per_step": {k: float(np.median(v)) for k, v in ms.items()}}


def batch_decode_profile(engine, prompts, steps: int) -> dict:
    """Wall and device time of the step that admits every prompt (chunk
    prefills and the first decode step), then per batched decode step once
    every slot is live (``engine.eos_token_id`` must be -1, so that all
    slots run ``steps``)."""
    def run(profiled: bool):
        for prompt in prompts:
            engine.submit(prompt, steps + 1)
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as admit_prof:
            start = time.perf_counter()
            engine.step()                  # admissions and the first step
            torch.cuda.synchronize()
            admit = time.perf_counter() - start
        n = 0
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            start = time.perf_counter()
            while engine.has_work:
                engine.step()
                n += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        return n, wall, admit, admit_prof, prof

    run(False)                             # warm-up
    n, wall, admit, _, _ = run(False)
    _, _, _, admit_prof, prof = run(True)
    per_kernel = _device_us(prof)
    device_ms = sum(per_kernel.values()) / 1e3 / n
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    admit_kernels = _device_us(admit_prof)
    admit_top = sorted(admit_kernels.items(), key=lambda kv: -kv[1])[:6]
    launches, copies = _launch_counts(prof)
    return {
        "slots": len(prompts),
        "admission_step_wall_ms": 1e3 * admit,
        "admission_step_device_ms": sum(admit_kernels.values()) / 1e3,
        "admission_top_kernels_ms": {k[:80]: v / 1e3 for k, v in admit_top},
        "steps": n,
        "wall_ms_per_step": 1e3 * wall / n,
        "tokens_per_s": len(prompts) * n / wall,
        "device_ms_per_step": device_ms,
        "busy_share": device_ms / (1e3 * wall / n),
        "device_launches_per_step": launches / n,
        "device_copies_per_step": copies / n,
        "top_kernels_ms_per_step": {k[:80]: v / 1e3 / n for k, v in top},
    }


def forward_profile(fn, images: int, repeats: int = 5) -> dict:
    """Wall (host clock, no profiler) and device ms per call of ``fn``, one
    forward of a batch of ``images``."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - start) / repeats
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    per_kernel = _device_us(prof)
    device_ms = sum(per_kernel.values()) / 1e3 / repeats
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "images": images,
        "wall_ms_per_batch": 1e3 * wall,
        "images_per_s": images / wall,
        "device_ms_per_batch": device_ms,
        "busy_share": device_ms / (1e3 * wall),
        "top_kernels_ms_per_batch": {k[:80]: v / 1e3 / repeats for k, v in top},
    }


def semantic_profile(dev) -> dict:
    """Part 4: the fused so400m tower's kernels and forwards."""
    from gvl_tpu_torch.ops import quant_matmul as qm
    from gvl_tpu_torch.perception.semantic import (
        NaFlexConfig,
        SigLIPSemanticEncoder,
        TorchSigLIPBackend,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-127, 128, (5888, 1152), generator=gen, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (6144, 1152), generator=gen, device=dev, dtype=torch.int8)
    scale, bias = torch.full((6144,), 1e-4, device=dev), torch.zeros(6144, device=dev)
    h = torch.randn(5888, 1152, generator=gen, device=dev).to(torch.bfloat16)
    g, b = torch.ones(1152, device=dev), torch.zeros(1152, device=dev)
    qkv = torch.randn(5888, 6144, generator=gen, device=dev).to(torch.bfloat16)
    packed = torch.randn(5888, 3456, generator=gen, device=dev).to(torch.bfloat16)
    att = dict(batch=8, seq_pad=736, kv_len=729, num_heads=16, sm_scale=72 ** -0.5)
    kernels = {
        "w8a8_matmul": kernel_device_ms(lambda: qm.w8a8_matmul(x, w, scale, bias),
                                        ("w8a8_matmul_kernel",), 20),
        "ln_quant": kernel_device_ms(lambda: qm.ln_quant(h, g, b, 40.0),
                                     ("ln_quant_kernel",)),
        "quant_static": kernel_device_ms(lambda: qm.quant_static(h, 40.0),
                                         ("quant_static_kernel",)),
        "attention_fused_qkv": kernel_device_ms(
            lambda: qm.attention_fused_qkv(qkv, dh_pad=128, out_scale_inv=40.0, **att),
            ("encoder_attention_",), 5),
        "attention_packed_multihead": kernel_device_ms(
            lambda: qm.attention_packed_multihead(packed, head_dim=72, out_scale_inv=40.0,
                                                  **att),
            ("encoder_attention_",), 5),
        "attention_qkv_packed": kernel_device_ms(
            lambda: qm.attention_qkv_packed(packed, head_dim=72, **att),
            ("encoder_attention_",), 5),
    }
    print(f"fused kernels, device ms per launch: {kernels}", flush=True)
    del x, w, h, qkv, packed

    encoder = SigLIPSemanticEncoder.with_random_tower(NaFlexConfig(quant_fused=True),
                                                      device=dev, seed=0)
    fused = encoder.backend
    bf16 = TorchSigLIPBackend(fused.tower)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (8, 384, 384, 3), dtype=np.uint8)
    regions = rng.integers(0, 256, (16, 128, 128, 3), dtype=np.uint8)
    out = {"kernel_device_ms": kernels}
    for label, batch in (("frames_b8", frames), ("regions_b16", regions)):
        out[f"fused_{label}"] = forward_profile(lambda: fused(batch), len(batch))
        out[f"bf16_{label}"] = forward_profile(lambda: bf16(batch), len(batch))
        print(f"{label}: fused {out[f'fused_{label}']}\n  bf16 {out[f'bf16_{label}']}",
              flush=True)
    return out


def call_profile(fn, repeats: int = 3) -> dict:
    """Wall ms per call of ``fn`` (host clock, no profiler), device ms and
    CUDA kernel launches per call (profiler), the busy share and the top
    device kernels."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - start) / repeats
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    per_kernel = _device_us(prof)
    device_ms = sum(per_kernel.values()) / 1e3 / repeats
    launches, copies = _launch_counts(prof)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall, "device_ms": device_ms, "busy_share": device_ms / wall,
            "kernel_launches": launches / repeats, "copies": copies / repeats,
            "top_kernels_ms": {k[:80]: v / 1e3 / repeats for k, v in top}}


def perception_profile(dev) -> dict:
    """Part 5: the perception encoders' attention shapes and entry points."""
    from gvl_tpu_torch.audio.processor import AudioConfig, AudioProcessor
    from gvl_tpu_torch.ops.attention import HEAD_DIMS, flash_attention
    from gvl_tpu_torch.perception import encoders as E

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {"segmenter image encoder [32,6,256,64]": (32, 6, 256, 256, 64),
              "mask decoder cross [128,8,8->257,32]": (128, 8, 8, 257, 32),
              "ASR encoder [4,4,300,64]": (4, 4, 300, 300, 64),
              "ASR decode cross [4,4,1->300,64]": (4, 4, 1, 300, 64),
              "mini-SigLIP image tower [8,6,64,64]": (8, 6, 64, 64, 64),
              "mini-SigLIP MAP head [8,6,1->64,64]": (8, 6, 1, 64, 64),
              "mini-SigLIP text tower [7,6,32,64]": (7, 6, 32, 32, 64),
              "VideoMAE [3,4,392,64]": (3, 4, 392, 392, 64),
              "HiCo pool [8,8,1->16,176]": (8, 8, 1, 16, 176),
              "head 192 [4,8,256,192]": (4, 8, 256, 256, 192)}
    attention = {}
    for name, (b, h, sq, sk, d) in shapes.items():
        q = torch.randn(b, h, sq, d, generator=gen, device=dev)
        k, v = (torch.randn(b, h, sk, d, generator=gen, device=dev) for _ in range(2))
        attention[name] = kernel_device_ms(lambda: flash_attention(q, k, v),
                                           ("flash_attention_kernel",))
        if d not in HEAD_DIMS:   # and with the wrapper's head pads and slice
            attention[f"{name}, all kernels of the call"] = kernel_device_ms(
                lambda: flash_attention(q, k, v), ("",))
    print(f"flash_attention at the encoders' shapes, device ms per launch: {attention}",
          flush=True)
    enc = E.random_encoders(dev, seed=11)
    queries, descs = E.retrieval_texts(64, seed=11)
    frames = E.gameplay_frames(32, seed=11)
    hud = E.hud_frames(8, seed=11)
    audio, speech = E.soundtrack(8, seed=11), E.soundtrack(24, seed=12)
    processor = AudioProcessor(AudioConfig(max_audio_length=6.0, chunk_overlap=0.0),
                               asr_backend=enc.asr, event_backend=enc.events)
    calls = {
        "retriever, 128 texts": lambda: enc.retriever.encode(descs + queries),
        "segmenter, 32 frames x 4 concepts": lambda: enc.segmenter.segment_batch(
            frames, list(range(32)), list(E.CONCEPTS)),
        "OCR, 8 HUD frames": lambda: enc.ocr.batch(hud),
        "audio events, 8 s": lambda: processor.detect_audio_events(audio, 16000),
        "byte ASR, 4 windows of 6 s": lambda: processor.transcribe(speech, 16000),
    }
    out = {"flash_device_ms_per_launch": attention}
    for name, fn in calls.items():
        out[name] = call_profile(fn)
        print(f"{name}: {out[name]}", flush=True)
    return out


def kernel_profile(dev) -> dict:
    """Part 1: device ms per launch of the decoders' kernels."""
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

    q, k, v = randn(1, 10, 4096, 64), randn(1, 5, 4096, 64), randn(1, 5, 4096, 64)
    qd = randn(1, 10, 64)
    kc = randn(1, 5, 4608, 64, dtype=torch.bfloat16)
    vc = randn(1, 5, 4608, 64, dtype=torch.bfloat16)
    lengths = torch.tensor([3072], dtype=torch.int32, device=dev)
    qa_k, qa_v = randn(1, 5, 64), randn(1, 5, 64)     # the QA model's f32 rows
    cache, cache_v = (randn(1, 8, 1024, 128, dtype=torch.bfloat16) for _ in range(2))
    row, row_v = (randn(1, 8, 128, dtype=torch.bfloat16) for _ in range(2))
    pos = torch.tensor([517], dtype=torch.int32, device=dev)
    qc = randn(1, 10, 2048, 64)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    k_all = randn(4, 4, 8, 1024, 128, dtype=torch.bfloat16)
    v_all = randn(4, 4, 8, 1024, 128, dtype=torch.bfloat16)
    q4 = randn(4, 32, 128, dtype=torch.bfloat16)
    lens4 = torch.tensor([129, 134, 140, 144], dtype=torch.int32, device=dev)
    rows4 = randn(4, 8, 128, dtype=torch.bfloat16)
    q8, k8 = randn(1, 32, 128, 128, dtype=torch.bfloat16), randn(1, 8, 128, 128,
                                                                 dtype=torch.bfloat16)
    qs, ks = (randn(8, 16, 729, 72, dtype=torch.bfloat16) for _ in range(2))
    probe = randn(8, 16, 1, 72, dtype=torch.bfloat16)
    kernels = {
        "flash_attention": kernel_device_ms(
            lambda: flash_attention(q, k, v, causal=True), ("flash_attention_kernel",), 20),
        "flash_attention 8B bf16 S128": kernel_device_ms(
            lambda: flash_attention(q8, k8, k8, causal=True), ("flash_attention_kernel",)),
        "flash_attention so400m bf16 [8,16,729,72]": kernel_device_ms(
            lambda: flash_attention(qs, ks, ks), ("flash_attention_kernel",), 20),
        "flash_attention MAP head [8,16,1,72] over 729": kernel_device_ms(
            lambda: flash_attention(probe, ks, ks), ("flash_attention_kernel",)),
        "decode_attention": kernel_device_ms(
            lambda: decode_attention(qd, kc, vc, lengths), ("decode_attention_kernel",)),
        "cache_append": kernel_device_ms(
            lambda: cache_append(cache, row, pos), ("cache_append_kernel",)),
        "chunk_attention": kernel_device_ms(
            lambda: chunk_attention(qc, kc, vc, start), ("chunk_attention_kernel",), 20),
        "decode_attention_stacked": kernel_device_ms(
            lambda: decode_attention_stacked(q4, k_all, v_all, lens4, 2),
            ("decode_attention_kernel",)),
        "cache_append_stacked": kernel_device_ms(
            lambda: cache_append_stacked(k_all, rows4, lens4 - 1, 2),
            ("cache_append_kernel",)),
        "cache_append_kv 8B": kernel_device_ms(
            lambda: cache_append_kv(cache, cache_v, row, row_v, pos), ("cache_append_kernel",)),
        "cache_append_stacked_kv 8B scan": kernel_device_ms(
            lambda: cache_append_stacked_kv(k_all, v_all, rows4, rows4, lens4 - 1, 2),
            ("cache_append_kernel",)),
        "cache_append_kv QA f32 into bf16": kernel_device_ms(
            lambda: cache_append_kv(kc, vc, qa_k, qa_v, lengths - 1),
            ("cache_append_kernel",)),
    }
    print(f"device ms per launch: {kernels}", flush=True)
    return kernels


def decode_profiles(dev) -> dict:
    """Parts 2 and 3: decode steps of the QA model and the 8B geometry
    (wall and device ms, busy share, launches per step)."""
    from gvl_tpu_torch.agent.core import create_qa_backend
    from gvl_tpu_torch.models.byte_tokenizer import ByteTokenizer
    from gvl_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Engine, init_params, stack_layers
    from gvl_tpu_torch.serving import ContinuousBatchingEngine
    from gvl_tpu_torch.training.qa_lm_train import encode_sample, generate_qa_sample

    backend = create_qa_backend(REPO / "outputs" / "qa_lm", device=dev)
    rng = np.random.default_rng(1234)
    qa_prompts = []
    for _ in range(4):
        tokens, _, prompt_len = encode_sample(generate_qa_sample(rng), ByteTokenizer(),
                                              3072)
        qa_prompts.append([int(t) for t in tokens[:prompt_len]])
    backend.engine.eos_token_id = -1      # decode all 48 steps
    qa = decode_profile(backend.engine, qa_prompts[0], 48)
    qa["prompt_tokens"] = len(qa_prompts[0])
    print(f"QA decode: {qa}", flush=True)
    # the decode write through the append kernel against the scatter route,
    # everything else alike
    cfg = backend.engine.config
    scatter = Qwen3Engine(dataclasses.replace(cfg, use_cache_append_kernel=False),
                          backend.engine.model.state_dict(), eos_token_id=-1, device=dev)
    qa_route = route_ab({"append_kernel": backend.engine, "scatter": scatter},
                        qa_prompts[0], 48)
    print(f"QA decode, write route A/B: {qa_route}", flush=True)
    del scatter
    batch = ContinuousBatchingEngine(backend.engine.config,
                                     backend.engine.model.state_dict(),
                                     eos_token_id=-1, num_slots=4, device=dev)
    qa_batch = batch_decode_profile(batch, qa_prompts, 48)
    print(f"QA batched decode: {qa_batch}", flush=True)
    del backend, batch

    cfg = Qwen3Config(hidden_size=4096, num_layers=4, num_heads=32, num_kv_heads=8,
                      head_dim=128, intermediate_size=12288, vocab_size=151936,
                      max_cache_length=1024)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = Qwen3Engine(cfg, params, eos_token_id=-1, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (128,),
                           generator=torch.Generator().manual_seed(0)).tolist()
    big = decode_profile(engine, prompt, 16)
    print(f"8B decode: {big}", flush=True)
    del engine
    scan = ContinuousBatchingEngine(
        dataclasses.replace(cfg, scan_layers=True), stack_layers(params, cfg),
        eos_token_id=-1, num_slots=4, device=dev)
    gen_cpu = torch.Generator().manual_seed(1)
    scan_prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen_cpu).tolist()
                    for n in (128, 100, 77, 128)]
    big_batch = batch_decode_profile(scan, scan_prompts, 16)
    print(f"8B scan batched decode: {big_batch}", flush=True)
    del scan, params
    torch.cuda.empty_cache()
    return {"qa_decode": qa, "qa_decode_route_ab": qa_route, "qa_batch_decode": qa_batch,
            "decode_8b": big, "scan_8b_batch_decode": big_batch}


PARTS = {"kernels": kernel_profile, "decode": decode_profiles,
         "semantic": semantic_profile, "perception": perception_profile}


def main(parts=tuple(PARTS)) -> dict:
    dev = resolve_device("cuda")
    # f32 products and convolutions in full f32, as chip_smoke.py checks them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"device": torch.cuda.get_device_name(0)}
    for name in parts:
        out[name] = PARTS[name](dev)
    return out


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--only"] and sys.argv[2:] and sys.argv[2] in PARTS:
        print(json.dumps(main((sys.argv[2],))))
    elif sys.argv[1:]:
        sys.exit(f"usage: python -m gvl_tpu_torch.device_times [--only {'|'.join(PARTS)}]")
    else:
        print(json.dumps(main()))
