#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gvl_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
``nvcc``.  Phases, each printing its elapsed time:

0. device: the card's name and power limit (``nvidia-smi``), PyTorch's version;
1. build: one ``nvcc`` command compiles ``gvl_tpu_torch/csrc/*.cu``;
2. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the served models give it, with the tolerance stated; then each
   kernel's time, its plain version's, one PyTorch library call's that
   computes the same function (a yardstick only) and the least time the card
   could take (bytes over 3.35 TB/s or operations over the type's peak);
3. the in-repo QA model (``outputs/qa_lm``, real weights) behind
   ``create_qa_backend``: held-out accuracy through ``evaluate_qa_lm`` (n 40,
   seed 1234) against ``outputs/qa_lm/metrics.json``, the same 40 samples
   through the plain path on the card, and one chat through
   ``Qwen3ChatBackend.stream``;
4. the 8B decoder's layer geometry at depth 4, random bf16 weights: kernel
   path against plain path (prefill and first-step logits), then 16 greedy
   steps.

Kernel launch counts are zeroed just before each served run (the kernel
path of phases 3 and 4) and read just after it.  The last two lines are a
JSON object of per-kernel numbers and ``{"ok": true, "device": ...}``.  Any
failed check raises, so the exit code is not 0; a watchdog turns a hang
into a traceback and an exit.  No JAX and nothing of ``gvl_tpu`` is used.
"""

from __future__ import annotations

import faulthandler
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
QA_CKPT = REPO / "outputs" / "qa_lm"
WATCHDOG_S = 1100        # below the 1200 s the run is allowed
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
QA_SEED, QA_SAMPLES = 1234, 40
QA_ACCURACY_SLACK = 0.075  # 3 of 40 answers
QA_MIN_AGREE = 38          # kernel vs plain path answers, of 40
F32_TOL = (1e-4, 1e-4)     # (atol, rtol): f32 sums in another order
BF16_TOL = (2e-2, 2e-2)    # a few units of bf16's 2**-8 relative precision
# 8B logits: the bf16 kernel path may stray from an f32 evaluation of the
# same weights by at most this multiple of the bf16 plain path's own error
BF16_ERR_RATIO = 1.5

_T0 = time.perf_counter()


def log(phase: str, message: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {phase}: {message}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def assert_close(what: str, got, want, tol: tuple[float, float]) -> float:
    atol, rtol = tol
    err = max_err(got, want)
    excess = ((got.float() - want.float()).abs()
              - (atol + rtol * want.float().abs())).max().item()
    ok = excess <= 0 and math.isfinite(err)
    log("kernels", f"{what}: max abs err {err:.3g} (atol {atol}, rtol {rtol})"
        f" {'ok' if ok else 'MISMATCH'}")
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


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def check_kernels(dev) -> list[dict]:
    import torch

    from gvl_tpu_torch.ops.attention import attention_reference, flash_attention
    from gvl_tpu_torch.ops.cache_update import cache_append, cache_append_reference
    from gvl_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_reference,
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
                     want, BF16_TOL)

    # cache_append: in place, the written rows right, every other row intact
    append_err = 0.0
    for name, batch, positions in [("8B B1", 1, [517]), ("8B B4", 4, [0, 7, 513, 1023])]:
        cache = randn(batch, 8, 1024, 128, dtype=torch.bfloat16)
        new = randn(batch, 8, 128, dtype=torch.bfloat16)
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        want = cache_append_reference(cache, new, pos)
        ptr = cache.data_ptr()
        got = cache_append(cache, new, pos)
        torch.cuda.synchronize()
        if got is not cache or got.data_ptr() != ptr:
            raise AssertionError("cache_append did not write in place")
        if not torch.equal(got, want):
            raise AssertionError(f"cache_append {name}: rows differ from the plain version")
        append_err = max(append_err, max_err(got, want))
        log("kernels", f"cache_append {name} positions {positions}: same data_ptr,"
            " written rows equal, all other rows bit-identical: ok")

    # times at the main path's shapes
    q, k, v, causal, kv_len = flash_in
    pairs = attention_pairs(q.shape[2], k.shape[2], causal, kv_len)
    flash_bound = bound_ms(sum(t.nbytes for t in (q, k, v)) + q.nbytes,
                           4.0 * q.shape[0] * q.shape[1] * q.shape[3] * pairs, q.dtype)
    flash = dict(
        name="flash_attention", route="cuda",
        source="gvl_tpu_torch/csrc/flash_attention.cu",
        replaces="gvl_tpu/ops/attention.py:158",
        shape="QA prefill: q [1,10,4096,64] f32, k/v [1,5,4096,64], causal",
        max_abs_err=flash_err,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: attention_reference(q, k, v, causal=True), 5),
        bound_ms=flash_bound[0], bound_by=flash_bound[1],
        library_ms=time_ms(lambda: library_flash(q, k, v, True)),
    )

    live = 3072   # a usual QA prompt: the decode reads ~3K of the 4608 rows
    q = randn(1, 10, 64)
    kc = randn(1, 5, 4608, 64, dtype=torch.bfloat16)
    vc = randn(1, 5, 4608, 64, dtype=torch.bfloat16)
    lengths = torch.tensor([live], dtype=torch.int32, device=dev)
    dec_err = max_err(decode_attention(q, kc, vc, lengths),
                      decode_attention_reference(q, kc, vc, lengths))
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
        bound_ms=dec_bound[0], bound_by=dec_bound[1],
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
        max_abs_err=append_err,
        ms=time_ms(lambda: cache_append(cache, new, pos), 100),
        plain_ms=time_ms(lambda: cache_append_reference(cache, new, pos), 100),
        bound_ms=app_bound[0], bound_by=app_bound[1],
        library_ms=time_ms(lambda: cache.index_copy_(2, pos_long, new3), 100),
    )
    rows = [flash, decode, append]
    for row in rows:
        log("kernels", f"{row['name']} at {row['shape']}: kernel {row['ms']:.4f} ms,"
            f" plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms,"
            f" bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    return rows


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

    def generate(self, prompt_ids, **kw) -> list[int]:
        import torch

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
    from gvl_tpu_torch.ops.attention import flash_attention
    from gvl_tpu_torch.ops.cache_update import cache_append
    from gvl_tpu_torch.ops.decode_attention import decode_attention

    return flash_attention, decode_attention, cache_append


def kernel_launches() -> dict[str, int]:
    return {f.__name__: f.launches for f in kernel_wrappers()}


def reset_launches() -> None:
    for f in kernel_wrappers():
        f.launches = 0


def run_qa(dev) -> dict[str, int]:
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
    launches = kernel_launches()
    log("qa", f"kernel path: accuracy {got['accuracy']:.3f} (metrics.json {want}),"
        f" by_family {json.dumps(got['by_family'], sort_keys=True)}")
    log("qa", f"kernel path: {timed.summary()}; launches {launches}, "
        f"{sum(launches.values()) / max(timed.decode_steps + timed.prompts, 1):.1f}"
        " per generated token")

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
    return launches


def run_8b(dev) -> dict[str, int]:
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
    launches = kernel_launches()
    ref = TimedEngine(plain).generate(ids, max_new_tokens=16, temperature=0.0)
    same = sum(a == b for a, b in zip(out, ref))
    log("8b", f"kernel path: {timed.summary()}; launches {launches}; greedy tokens"
        f" equal to the plain path: {same}/{len(out)}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if len(out) != 16:
        raise AssertionError(f"8B engine produced {len(out)} tokens, not 16")
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
    log("build", f"nvcc {build.seconds:.1f} s, one command: {' '.join(build.command)}"
        if build.command else f"library already built at {build.path}")

    rows = check_kernels(dev)
    launches = run_qa(dev)
    for name, n in run_8b(dev).items():
        launches[name] += n
    log("launches", f"main path (QA kernel path + 8B generation): {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    for row in rows:
        row["launches"] = launches[row["name"]]

    faulthandler.cancel_dump_traceback_later()
    print(nvidia_smi(), flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
