#!/usr/bin/env python3
"""Figures of the port that ``chip_smoke.py`` leaves out to keep its time.

    python3 card_figures.py qa                  # the QA model's held-out accuracy
    python3 card_figures.py fused               # the fused W8A8 tower against bf16
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


FIGURES = {"qa": qa_figure, "fused": fused_figure, "gvp_light": gvp_light_figure,
           "open_vocab": open_vocab_figure, "clip": clip_figure, "lora": lora_figure}


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
