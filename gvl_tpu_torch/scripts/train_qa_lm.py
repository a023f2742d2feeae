"""Train the byte-level timeline-QA LM and save a checkpoint (the port's
copy of ``scripts/train_qa_lm.py``, on ``--device``).

    python -m gvl_tpu_torch.scripts.train_qa_lm --out outputs/qa_lm [--device cpu]

Fully offline: grounded-QA transcripts are procedurally generated with
known answers (:mod:`gvl_tpu_torch.training.qa_lm_train`).  Every flag of
the JAX script, plus ``--device`` (default ``cuda``; raises without a card
unless ``cpu`` is asked for).  The checkpoint is in the JAX package's
layout: either package serves it.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.training.qa_lm_train import (
    COPY_FAMILY_WEIGHTS,
    FAMILY_WEIGHTS,
    QATrainConfig,
    evaluate_qa_lm,
    load_qa_lm,
    qa_lm_v5_config,
    save_qa_lm,
    short_curriculum_config,
    train_qa_lm,
)

logger = logging.getLogger("train_qa_lm")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="outputs/qa_lm")
    parser.add_argument("--steps", type=int, default=8000)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pool-size", type=int, default=0,
                        help="0 = stream never-repeating samples")
    parser.add_argument("--eval-samples", type=int, default=60)
    parser.add_argument("--init-from", default=None, metavar="CKPT_DIR",
                        help="warm-start from an existing qa_lm checkpoint")
    parser.add_argument("--copy-heavy", action="store_true",
                        help="upweight the copy-from-context families "
                             "(timestamp/ocr)")
    parser.add_argument("--family-weights", type=float, nargs=6,
                        default=None, metavar="W",
                        help="explicit sampling weights over "
                             "(binary, mcq, timestamp, ocr, audio, causal)"
                             " — overrides --copy-heavy")
    parser.add_argument("--lookup-frac", type=float, default=0.0,
                        help="per-sample probability of a lookup-"
                             "pretraining sample")
    parser.add_argument("--short-mix", type=float, default=0.0,
                        help="per-sample probability of the short profile "
                             "inside a full phase")
    parser.add_argument("--curriculum", default="full",
                        choices=["full", "short"],
                        help="'short': phase-A curriculum — 640-byte bare "
                             "prompts, 2-6 events")
    parser.add_argument("--geometry", default="v4", choices=["v4", "v5"],
                        help="v4: the 15M rung; v5: the 62M rung")
    parser.add_argument("--pipeline-frac", type=float, default=0.0,
                        help="per-sample probability of a pipeline-"
                             "rendered sample")
    parser.add_argument("--max-len", type=int, default=None,
                        help="training byte budget (default 3072; "
                             "4096 for --geometry v5)")
    parser.add_argument("--compute-dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="loss-path cast dtype (default: bfloat16 "
                             "for the 62M v5 geometry, float32 otherwise)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)

    if args.family_weights is not None:
        total = sum(args.family_weights)
        weights = tuple(w / total for w in args.family_weights)
    else:
        weights = (COPY_FAMILY_WEIGHTS if args.copy_heavy or
                   args.curriculum == "short" else FAMILY_WEIGHTS)
    common = dict(steps=args.steps, batch_size=args.batch_size,
                  learning_rate=args.lr, seed=args.seed,
                  pool_size=args.pool_size, family_weights=weights,
                  short_mix=args.short_mix,
                  lookup_frac=args.lookup_frac,
                  pipeline_frac=args.pipeline_frac,
                  compute_dtype=args.compute_dtype
                  or ("bfloat16" if args.geometry == "v5" else "float32"))
    if args.geometry == "v5":
        # full-context phases train at max_len 4096 with each layer
        # rematerialised; phase A (640 bytes) trains without
        common["model"] = qa_lm_v5_config(remat=(args.curriculum != "short"))
    if args.curriculum != "short" and (args.max_len or args.geometry == "v5"):
        common["max_len"] = args.max_len or 4096
    cfg = (short_curriculum_config(**common)
           if args.curriculum == "short" else QATrainConfig(**common))
    init_params = None
    if args.init_from:
        _, init_params = load_qa_lm(args.init_from, device=device)
        logger.info("warm start from %s", args.init_from)
    t0 = time.time()
    params = train_qa_lm(cfg, init_params=init_params, device=device)
    logger.info("trained in %.1f s", time.time() - t0)

    if args.eval_samples <= 0:
        save_qa_lm(params, args.out, cfg.model)
        logger.info("saved %s (eval skipped)", args.out)
        return 0

    def evaluate(**kw):
        return evaluate_qa_lm(params, cfg.model, n_samples=args.eval_samples,
                              device=device, **kw)

    metrics = evaluate(max_len=cfg.max_len)
    logger.info("held-out grounded QA: acc=%.3f by_family=%s",
                metrics["accuracy"], metrics["by_family"])
    extra = {}
    if args.pipeline_frac > 0:
        extra["heldout_pipeline"] = evaluate(pipeline=True, max_len=cfg.max_len)
        logger.info("pipeline-rendered held-out: acc=%.3f by_family=%s",
                    extra["heldout_pipeline"]["accuracy"],
                    extra["heldout_pipeline"]["by_family"])
    if args.curriculum == "short":
        extra["heldout_short"] = evaluate(serving_sections=False, n_events_range=(2, 6),
                                          short_system=True)
        logger.info("short-context held-out: acc=%.3f by_family=%s",
                    extra["heldout_short"]["accuracy"],
                    extra["heldout_short"]["by_family"])

    save_qa_lm(params, args.out, cfg.model)
    (Path(args.out) / "metrics.json").write_text(json.dumps({
        "heldout": _jax_metrics(metrics), "steps": args.steps,
        "curriculum": args.curriculum,
        "geometry": args.geometry,
        "pipeline_frac": args.pipeline_frac,
        "family_weights": list(weights),
        "pool_size": args.pool_size, "seed": args.seed,
        **{k: _jax_metrics(v) for k, v in extra.items()}},
        indent=2))
    logger.info("saved %s", args.out)
    return 0


def _jax_metrics(metrics: dict) -> dict:
    """``evaluate_qa_lm``'s result without the port's extra keys (each
    sample's answer and family), as the JAX script writes it."""
    return {k: v for k, v in metrics.items() if k not in ("answers", "families")}


if __name__ == "__main__":
    raise SystemExit(main())
