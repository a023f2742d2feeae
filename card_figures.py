#!/usr/bin/env python3
"""Figures of the port that ``chip_smoke.py`` leaves out to keep its time.

    python3 card_figures.py qa                  # the QA model's held-out accuracy
    python3 card_figures.py fused               # the fused W8A8 tower against bf16
    python3 card_figures.py grad_drift          # phase 18's gradient check, read further
    python3 card_figures.py --cpu gvp_light open_vocab clip lora

Run from the root of the repository, on a machine with one CUDA card and
``nvcc``; ``--cpu`` runs the figures on the CPU instead (the trained-weight
figures below read ``outputs/``, which the card's copy leaves out).

``qa``: ``evaluate_qa_lm`` on the in-repo QA model (``outputs/qa_lm``)
through the port's ``Qwen3Engine``, n 32 at each of seeds 77, 1234 and
2026 with ``max_len`` 4096: the setting of ``bench.py``'s ``bench_qa_lm``,
whose figure the repository's BENCH_r05 records (0.906 / 0.875 / 0.906).

``fused``: the SigLIP so400m tower with seeded random bf16 weights, 8
Gaussian 384 x 384 inputs, the fused W8A8 tower calibrated on the first 4
of those very inputs (``bench.py``'s ``bench_siglip_tower`` setup), and the
pooled cosine of each input's output against the bf16 tower's; once with
the port's initialiser (``init_tower_params``: untruncated normal
matrices) and once with every matrix redrawn as Flax's default
initialiser draws it, which ``bench.py``'s tower uses (lecun normal:
a normal truncated at two standard deviations, rescaled to variance
1/fan_in).

``gvp_light``: the ``gvp_light`` arm (the ``light`` preset without the
segmenter: zero-shot mini-SigLIP labels, whole-frame embeddings, OCR,
audio; the grounded fake answers) through the port's
``FullPipelineRunner`` on the trained weights of ``outputs/``, over the
synthetic samples of the phase runners' loaders (n 16 each, seed 42):
phase 1 (``glitchbench``, ``physgame``) and phase 3 (``longvideobench``,
``mlvu``), n 32 a phase, as VERDICT.md read the JAX package (0.938 in
both).

``open_vocab``: ``bench.py``'s ``bench_open_vocab`` (8 base scenes, seed
4321): the trained composite's detection and label accuracy under the
canonical prompts and the unseen paraphrases, with the lexicon resolver
and with the raw towers (BENCH_r05: 0.70 / 0.824, 0.6 / 0.857, 0.25 /
0.455).

``clip``: ``bench.py``'s ``bench_clip_encoder`` (48 base clips, seed 1234):
direction, kind and event accuracy of the trained clip classifier and the
frame-shuffled control (BENCH_r05: 0.979, 1.0, 1.0; 0.171).

``lora``: the QA model served with the in-repository LoRA adapter
(``create_reasoning_core(checkpoint_path="outputs/qa_lm",
lora_path="outputs/lora_adapter")``), ``evaluate_qa_lm`` n 60 on the
``causal`` family and on the default mix (seed 1234), as
``scripts/finetune_lora.py`` measured the adapter (its
``adapter_config.json``: lora_causal 0.633, lora_mix 0.833; base 0.0 and
0.883); whether the adapter merged or was skipped (ROADMAP C6) is part of
the reading.

``grad_drift``: ``chip_smoke.py`` phase 18's gradient check, read on more
batches (seeds 18 to 25; 2 rows of phase B's batch of 16 x 4096 each, the
served QA model with remat) over 3 trainer steps, in two modes: ``shared``,
the check as the script makes it (every path takes its gradients at the
f32 path's parameters), and, on seeds 18 to 20, ``own``, each path along
its own trajectory with its own optimizer.  Five paths: the kernel path
and the plain path in bf16; two witnesses in bf16, the plain path with
PyTorch's ``scaled_dot_product_attention`` as the attention forward (a
library's flash kernel in B1's place, for the forward and the backward's
``delta`` alike; a yardstick the port never calls) and the plain path with
the batch's two rows swapped (the same loss, its sums over the batch in
another order); and the plain path in f32, the truth.  Per step and path:
the worst share of the script's limit (relative L2 error against the truth
over 1.5 x the plain path's, plus 1e-3; per parameter tensor and the
loss), the share on layer 0's ``q_norm`` and the loss's relative error.

Prints the device (the card's name and power limit, or the CPU), one line
per reading, and one JSON object as its last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
QA_SEEDS, QA_SAMPLES, QA_MAX_LEN = (77, 1234, 2026), 32, 4096
FUSED_SEED, FUSED_BATCH, FUSED_CALIBRATION = 0, 8, 4


def qa_figure(dev) -> dict:
    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine
    from gvl_tpu_torch.training.qa_lm_train import evaluate_qa_lm, load_qa_lm

    cfg, state = load_qa_lm(REPO / "outputs" / "qa_lm", device=dev)
    engine = Qwen3Engine(cfg, state, eos_token_id=EOS_ID, device=dev)
    max_len = min(cfg.max_cache_length, QA_MAX_LEN)
    out = {}
    for seed in QA_SEEDS:
        start = time.perf_counter()
        got = evaluate_qa_lm(n_samples=QA_SAMPLES, seed=seed, engine=engine, max_len=max_len)
        correct = round(got["accuracy"] * QA_SAMPLES)
        out[seed] = {"accuracy": got["accuracy"], "correct": correct,
                     "by_family": got["by_family"]}
        print(f"qa seed {seed}: accuracy {got['accuracy']:.4f} ({correct}/{QA_SAMPLES}), "
              f"max_len {max_len}, {time.perf_counter() - start:.1f} s", flush=True)
    mean = float(np.mean([v["accuracy"] for v in out.values()]))
    print(f"qa mean over seeds {list(QA_SEEDS)}: {mean:.4f}", flush=True)
    return {"by_seed": out, "mean": mean, "n": QA_SAMPLES, "max_len": max_len}


def lecun_truncated(state: dict, gen: torch.Generator) -> dict:
    """``state`` with every matrix redrawn from Flax's default initialiser:
    a standard normal truncated to [-2, 2], times sqrt(1/fan_in) / 0.8796
    (the truncated normal's standard deviation), in the matrix's type."""
    out = dict(state)
    for name, w in state.items():
        if w.ndim == 2 and name.endswith("weight"):
            t = torch.empty(w.shape, device=w.device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            out[name] = (t * (w.shape[1] ** -0.5 / 0.87962566103423978)).to(w.dtype)
    return out


def fused_figure(dev) -> dict:
    from gvl_tpu_torch.models.siglip import SigLIPVisionConfig, init_tower_params, load_tower
    from gvl_tpu_torch.models.siglip_fused import prepare_fused_siglip, siglip_fused_apply

    cfg = SigLIPVisionConfig.so400m()
    gen = torch.Generator(device=dev).manual_seed(FUSED_SEED)
    port_init = init_tower_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    x = torch.randn(FUSED_BATCH, 384, 384, 3, generator=gen, device=dev).to(torch.bfloat16)
    out = {}
    for init, state in (("port init", port_init),
                        ("Flax lecun normal", lecun_truncated(port_init, gen))):
        with torch.inference_mode():
            fused = prepare_fused_siglip(state, cfg, x[:FUSED_CALIBRATION])
            got = siglip_fused_apply(fused, x, cfg)["pooled"].double()
            want = load_tower(cfg, state, dev)(x)["pooled"].double()
        cos = ((got * want).sum(-1) / (got.norm(dim=-1) * want.norm(dim=-1))).cpu().numpy()
        print(f"fused W8A8 vs bf16 so400m tower ({init}), {FUSED_BATCH} Gaussian inputs, "
              f"calibrated on the first {FUSED_CALIBRATION}: pooled cosine min "
              f"{cos.min():.6f} mean {cos.mean():.6f}; calibrated inputs "
              f"{cos[:FUSED_CALIBRATION].min():.6f}, others "
              f"{cos[FUSED_CALIBRATION:].min():.6f}", flush=True)
        out[init] = {"cosines": [float(c) for c in cos], "min": float(cos.min()),
                     "mean": float(cos.mean())}
    return out


GVP_PHASES = {"phase 1": ("glitchbench", "physgame"), "phase 3": ("longvideobench", "mlvu")}
GVP_SAMPLES, GVP_SEED = 16, 42
OPEN_VOCAB_SCENES, CLIP_COUNT = 8, 48


def _trained(*paths) -> None:
    """The trained-weight figures read ``outputs/``; without those files the
    ladders would take their fakes, so refuse instead."""
    missing = [p for p in paths if not (REPO / p).exists()]
    if missing:
        raise SystemExit(f"card_figures: trained weights missing: {missing}")


def gvp_light_figure(dev) -> dict:
    from gvl_tpu_torch.eval.model_configs import get_model_config
    from gvl_tpu_torch.eval.model_inference import FullPipelineRunner, check_correctness
    from gvl_tpu_torch.eval.samples import SyntheticLoader

    _trained("outputs/minisiglip", "outputs/ocr_params.npz", "outputs/audio_event_params.npz",
             "outputs/asr", "outputs/retriever")
    out = {}
    for phase, loaders in GVP_PHASES.items():
        start = time.perf_counter()
        runner = FullPipelineRunner(get_model_config("gvp_light"), use_cache=False, device=dev)
        per_loader = {}
        for name in loaders:
            samples = SyntheticLoader(name, GVP_SEED).synthetic_samples(GVP_SAMPLES)
            hits = []
            for sample in samples:
                result = runner.run_inference(sample)
                if "error" in result:
                    raise RuntimeError(f"{sample.sample_id}: {result['error']}")
                hits.append(check_correctness(result["predicted"], sample))
            per_loader[name] = {"correct": int(sum(hits)), "n": len(hits),
                                "wrong": [s.sample_id for s, h in zip(samples, hits) if not h]}
        correct = sum(v["correct"] for v in per_loader.values())
        n = sum(v["n"] for v in per_loader.values())
        print(f"gvp_light {phase} ({', '.join(loaders)}, seed {GVP_SEED}): {correct}/{n} "
              f"= {correct / n:.4f} (VERDICT.md, JAX: 0.938); wrong "
              f"{[w for v in per_loader.values() for w in v['wrong']]}; "
              f"{time.perf_counter() - start:.1f} s", flush=True)
        out[phase] = {"correct": correct, "n": n, "accuracy": correct / n,
                      "by_loader": per_loader}
    return out


def open_vocab_figure(dev) -> dict:
    from gvl_tpu_torch.perception.open_vocab import OpenVocabSamBackend
    from gvl_tpu_torch.training.siglip_train import UNSEEN_PROMPTS, evaluate_open_vocab

    _trained("outputs/sam_params.npz", "outputs/minisiglip", "outputs/retriever")
    seg, mini = str(REPO / "outputs" / "sam_params.npz"), str(REPO / "outputs" / "minisiglip")
    backend = OpenVocabSamBackend.from_trained_checkpoints(seg, mini, device=dev)
    raw = OpenVocabSamBackend.from_trained_checkpoints(seg, mini, retriever_dir=None,
                                                       device=dev)
    runs = {"canonical": (backend, None), "paraphrase": (backend, UNSEEN_PROMPTS),
            "paraphrase, raw tower": (raw, UNSEEN_PROMPTS)}
    out = {}
    for name, (b, prompts) in runs.items():
        m = evaluate_open_vocab(b, n_scenes=OPEN_VOCAB_SCENES, style="base", prompts=prompts)
        print(f"open vocab {name} ({OPEN_VOCAB_SCENES} base scenes): detection "
              f"{m['det_correct']:.4f}, label {m['label_acc']:.4f}, localized "
              f"{m['localized']:.4f}, {m['n_instances']} instances", flush=True)
        out[name] = m
    return out


def clip_figure(dev) -> dict:
    from gvl_tpu_torch.training.videomae_train import evaluate_clip_encoder, load_clip_encoder

    _trained("outputs/videomae")
    _, model = load_clip_encoder(REPO / "outputs" / "videomae", device=dev)
    m = evaluate_clip_encoder(model, n_clips=CLIP_COUNT, style="base")
    ctrl = evaluate_clip_encoder(model, n_clips=CLIP_COUNT, style="base", shuffle_frames=True)
    print(f"clip encoder ({CLIP_COUNT} base clips): direction {m['direction_acc']:.4f}, kind "
          f"{m['kind_acc']:.4f}, event {m['event_acc']:.4f}; shuffled frames: direction on "
          f"moving clips {ctrl['direction_acc_moving']:.4f}", flush=True)
    return {"trained": m, "shuffled": ctrl}


LORA_SAMPLES, LORA_SEED = 60, 1234


def lora_figure(dev) -> dict:
    import logging

    from gvl_tpu_torch.agent.core import create_reasoning_core
    from gvl_tpu_torch.training.qa_lm_train import evaluate_qa_lm

    adapter = REPO / "outputs" / "lora_adapter"
    _trained(REPO / "outputs" / "qa_lm", adapter)
    skipped = []

    class Skips(logging.Handler):
        def emit(self, record):
            if "skipping LoRA adapter" in record.getMessage():
                skipped.append(record.getMessage())

    log = logging.getLogger("gvl_tpu_torch.agent.core")
    log.addHandler(Skips())
    try:
        core = create_reasoning_core(checkpoint_path=str(REPO / "outputs" / "qa_lm"),
                                     lora_path=str(adapter), device=dev)
    finally:
        log.handlers = [h for h in log.handlers if not isinstance(h, Skips)]
    recorded = json.loads((adapter / "adapter_config.json").read_text())["metrics"]
    out = {"merged": not skipped, "skip_reason": skipped[0] if skipped else None}
    print(f"lora: adapter {'merged' if not skipped else 'skipped'}"
          + (f" ({skipped[0][:160]})" if skipped else ""), flush=True)
    for name, families in (("causal", ("causal",)), ("mix", None)):
        start = time.perf_counter()
        got = evaluate_qa_lm(n_samples=LORA_SAMPLES, seed=LORA_SEED, families=families,
                             engine=core.backend.engine)
        out[name] = {"accuracy": got["accuracy"], "by_family": got["by_family"],
                     "answers": got["answers"]}
        print(f"lora {name}: accuracy {got['accuracy']:.4f} (n {LORA_SAMPLES}); "
              f"adapter_config.json lora_{name} {recorded[f'lora_{name}']['accuracy']:.4f}, "
              f"base_{name} {recorded[f'base_{name}']['accuracy']:.4f}; "
              f"{time.perf_counter() - start:.1f} s", flush=True)
    return out


# grad_drift: chip_smoke.py phase 18's check (its constants), further batches
DRIFT_SEEDS, DRIFT_OWN_SEEDS = tuple(range(18, 26)), (18, 19, 20)
DRIFT_ROWS, DRIFT_STEPS, DRIFT_RATIO, DRIFT_FLOOR = 2, 3, 1.5, 1e-3
DRIFT_BATCH, DRIFT_LEN = 16, 4096
DRIFT_PHASE_B = dict(learning_rate=1.5e-4, pipeline_frac=0.3, short_mix=0.15, lookup_frac=0.1,
                     family_weights=(0.15, 0.15, 0.2, 0.2, 0.3, 0.0))
DRIFT_TENSOR = "layers.0.self_attn.q_norm.weight"


def sdpa_attention(q, k, v, *, causal=False, sm_scale=None, kv_len=None):
    """PyTorch's ``scaled_dot_product_attention`` with the plain version's
    arguments (no ``kv_len``: the training path has none)."""
    assert kv_len is None
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k, v = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                            scale=sm_scale)


def grad_drift_figure(dev) -> dict:
    from dataclasses import replace

    from gvl_tpu_torch.models.byte_tokenizer import ByteTokenizer
    from gvl_tpu_torch.models.qwen3 import load_model
    from gvl_tpu_torch.ops import attention
    from gvl_tpu_torch.training import qa_lm_train as T

    base_cfg, base = T.load_qa_lm(REPO / "outputs" / "qa_lm", device=dev)
    model_cfg = replace(base_cfg, remat=True)
    plain = model_cfg.plain()
    # name: (config, loss dtype, rows swapped, the plain path's attention
    # forward); the truth last, so that its gradients are still in place
    # for its update
    paths = {"kernel": (model_cfg, torch.bfloat16, False, None),
             "plain": (plain, torch.bfloat16, False, None),
             "sdpa": (plain, torch.bfloat16, False, sdpa_attention),
             "swapped": (plain, torch.bfloat16, True, None),
             "f32": (plain, torch.float32, False, None)}
    witnesses = ("kernel", "sdpa", "swapped")

    def rel_l2(x, ref) -> float:
        diff, norm = (x.float() - ref.float()).norm().item(), ref.float().norm().item()
        return diff / norm if norm else diff

    def loss_and_grads(model, dtype, tokens, mask, forward):
        reference = attention.attention_reference
        attention.attention_reference = forward or reference
        try:
            loss = T.qa_loss(model, tokens, mask, dtype)
            loss.backward()
        finally:
            attention.attention_reference = reference
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    def run(mode, cfg, tokens, mask) -> list:
        if mode == "shared":
            truth = T.training_model(plain, base, dev)
            state = dict(truth.state_dict())
            models = {name: truth if name == "f32" else load_model(c, state, dev)
                      for name, (c, *_) in paths.items()}
            opts = [T.qa_optimizer(cfg, truth.parameters())]
        else:
            models = {name: T.training_model(c, base, dev) for name, (c, *_) in paths.items()}
            opts = [T.qa_optimizer(cfg, m.parameters()) for m in models.values()]
        rows = []
        for step in range(DRIFT_STEPS):
            got = {}
            for name, (_, dtype, swapped, forward) in paths.items():
                model = models[name]
                got[name] = loss_and_grads(model, dtype, tokens.flip(0) if swapped else tokens,
                                           mask.flip(0) if swapped else mask, forward)
                if mode == "shared" and name != "f32":
                    for p in model.parameters():
                        p.grad = None
            truth_loss, truth_grads = got["f32"]
            err = {name: {**{n: rel_l2(got[name][1][n], g) for n, g in truth_grads.items()},
                          "loss": abs(got[name][0] - truth_loss) / abs(truth_loss)}
                   for name in ("plain",) + witnesses}
            row = {"step": step, "losses": {name: got[name][0] for name in paths},
                   "plain_loss_err": err["plain"]["loss"]}
            for name in witnesses:
                share = {n: e / (DRIFT_RATIO * err["plain"][n] + DRIFT_FLOOR)
                         for n, e in err[name].items()}
                worst = max(share, key=share.get)
                row[name] = {"worst": worst, "share": share[worst], "err": err[name][worst],
                             "plain_err": err["plain"][worst], "loss_err": err[name]["loss"],
                             "q_norm_share": share[DRIFT_TENSOR]}
            rows.append(row)
            for opt in opts:        # after the reading: the clip scales gradients in place
                opt.step()
        del models, opts, got
        return rows

    out = {}
    for seed in DRIFT_SEEDS:
        cfg = T.QATrainConfig(steps=DRIFT_STEPS, batch_size=DRIFT_BATCH, max_len=DRIFT_LEN,
                              pool_size=DRIFT_BATCH, seed=seed, log_every=0,
                              compute_dtype="bfloat16", model=model_cfg, **DRIFT_PHASE_B)
        tokens, mask = (torch.from_numpy(a[:DRIFT_ROWS]).to(dev) for a in T._render_batch(
            np.random.default_rng(seed), cfg, ByteTokenizer()))
        for mode in ("shared", "own") if seed in DRIFT_OWN_SEEDS else ("shared",):
            start = time.perf_counter()
            rows = run(mode, cfg, tokens, mask)
            out[f"seed {seed} {mode}"] = rows
            for r in rows:
                print(f"grad_drift seed {seed} {mode} step {r['step']}: plain loss err "
                      f"{r['plain_loss_err']:.4g}; " + "; ".join(
                          f"{name} worst {r[name]['worst']} share {r[name]['share']:.4f} "
                          f"(err {r[name]['err']:.4g}, plain {r[name]['plain_err']:.4g}), "
                          f"q_norm {r[name]['q_norm_share']:.4f}, loss err "
                          f"{r[name]['loss_err']:.4g}" for name in witnesses), flush=True)
            print(f"grad_drift seed {seed} {mode}: {time.perf_counter() - start:.1f} s",
                  flush=True)
    return out


FIGURES = {"qa": qa_figure, "fused": fused_figure, "gvp_light": gvp_light_figure,
           "open_vocab": open_vocab_figure, "clip": clip_figure, "lora": lora_figure,
           "grad_drift": grad_drift_figure}


def main(argv) -> int:
    cpu = "--cpu" in argv
    names = [a for a in argv if a != "--cpu"] or list(FIGURES)
    if any(n not in FIGURES for n in names):
        print(f"usage: python3 card_figures.py [--cpu] [{'|'.join(FIGURES)}] ...",
              file=sys.stderr)
        return 2
    if not cpu and not torch.cuda.is_available():
        print("card_figures: no CUDA device; these figures are read on the card "
              "(or pass --cpu)", file=sys.stderr)
        return 1
    from gvl_tpu_torch import resolve_device

    dev = resolve_device("cpu" if cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = "CPU" if cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    out = {"device": smi}
    for name in names:
        out[name] = FIGURES[name](dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
