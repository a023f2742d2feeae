"""Train the mini SigLIP vision+text model contrastively from scratch →
directory: the port's copy of ``scripts/train_siglip.py``, on ``--device``.

    python -m gvl_tpu_torch.scripts.train_siglip --out outputs/minisiglip \
        [--text-pretrain-steps N --text-corpus-weight W] [--device cpu]

The directory (``params.npz``, ``minisiglip_config.json``, ``metrics.json``)
is the JAX package's.  ``--device`` defaults to ``cuda`` and raises without
a card unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.training.siglip_train import (
    SigLIPTrainConfig,
    evaluate_minisiglip,
    minisiglip_from_state,
    save_minisiglip,
    train_minisiglip,
)

logger = logging.getLogger("train_siglip")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="outputs/minisiglip")
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval-crops", type=int, default=160)
    parser.add_argument("--composed-frac", type=float, default=0.0,
                        help="fraction of compositional noun×template captions "
                             "(0 reproduces the shipped checkpoint)")
    parser.add_argument("--text-pretrain-steps", type=int, default=0,
                        help="corpus-backed text-tower pretraining before VL alignment")
    parser.add_argument("--text-corpus-weight", type=float, default=0.0,
                        help="auxiliary word-context loss weight during VL training")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)

    cfg = SigLIPTrainConfig(steps=args.steps, batch_size=args.batch_size,
                            learning_rate=args.lr, seed=args.seed,
                            composed_frac=args.composed_frac,
                            text_pretrain_steps=args.text_pretrain_steps,
                            text_corpus_weight=args.text_corpus_weight)
    t0 = time.time()
    state = train_minisiglip(cfg, device=device)
    logger.info("trained in %.1f s", time.time() - t0)

    model = minisiglip_from_state(state, cfg.vision, cfg.text, device)
    metrics = {}
    for style in ("base", "aug", "holdout"):
        m = evaluate_minisiglip(model, n_crops=args.eval_crops, style=style,
                                canvas=cfg.canvas)
        metrics[style] = m
        logger.info("%s: zero-shot=%.3f entity=%.3f negative=%.3f "
                    "margin=%.3f", style, m["zero_shot_acc"],
                    m["entity_acc"], m["negative_acc"], m["margin"])

    save_minisiglip(state, args.out, cfg.vision, cfg.text, metrics=metrics)
    (Path(args.out) / "metrics.json").write_text(json.dumps({
        "zero_shot": metrics, "steps": args.steps,
        "seed": args.seed, "composed_frac": args.composed_frac,
        "text_pretrain_steps": args.text_pretrain_steps,
        "text_corpus_weight": args.text_corpus_weight},
        indent=2))
    logger.info("saved %s", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
