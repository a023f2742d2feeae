#!/usr/bin/env python3
"""Two figures of the port that ``chip_smoke.py`` leaves out to keep its time.

    python3 card_figures.py qa      # the QA model's held-out accuracy
    python3 card_figures.py fused   # the fused W8A8 tower against bf16

Run from the root of the repository, on a machine with one CUDA card and
``nvcc``.

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

Prints the card's name and power limit, one line per reading, and one
JSON object as its last line.
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


FIGURES = {"qa": qa_figure, "fused": fused_figure}


def main(argv) -> int:
    names = argv or list(FIGURES)
    if any(n not in FIGURES for n in names):
        print(f"usage: python3 card_figures.py [{'|'.join(FIGURES)}] ...", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("card_figures: no CUDA device; these figures are read on the card only",
              file=sys.stderr)
        return 1
    from gvl_tpu_torch import resolve_device

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    out = {"device": smi}
    for name in names:
        out[name] = FIGURES[name](dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
