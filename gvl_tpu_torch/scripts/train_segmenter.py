"""Train the promptable segmenter on synthetic gameplay scenes → npz: the
port's copy of ``scripts/train_segmenter.py``, on ``--device``.

    python -m gvl_tpu_torch.scripts.train_segmenter --out outputs/sam_params.npz \
        --steps 1500 [--device cpu]

Procedurally generated scenes with known ground-truth masks give the text
prompts grounding on the synthetic-gameplay domain.  The file is the JAX
package's flat npz (``PerceptionConfig.sam_checkpoint`` picks it up).
``--device`` defaults to ``cuda`` and raises without a card unless ``cpu``
is asked for.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.sam import SamConfig, save_segmenter_npz
from gvl_tpu_torch.training.segmenter_train import (
    SegTrainConfig,
    evaluate_segmenter,
    train_segmenter,
)

logger = logging.getLogger("train_segmenter")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="outputs/sam_params.npz")
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval-scenes", type=int, default=32)
    parser.add_argument("--styles", nargs="*", default=["base", "aug"],
                        help="training style families ('holdout' is the "
                             "out-of-distribution eval family — do not "
                             "train on it)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    if "holdout" in args.styles:
        parser.error("'holdout' is the held-out eval family")
    device = resolve_device(args.device)

    model_cfg = SamConfig()
    train_cfg = SegTrainConfig(
        image_size=model_cfg.image_size, steps=args.steps,
        batch_size=args.batch_size, learning_rate=args.lr, seed=args.seed,
        styles=tuple(args.styles))
    t0 = time.time()
    state = train_segmenter(model_cfg, train_cfg, device=device)
    logger.info("trained in %.1f s", time.time() - t0)

    for style in ("base", "holdout"):
        metrics = evaluate_segmenter(state, model_cfg, n_scenes=args.eval_scenes,
                                     style=style, device=device)
        logger.info("held-out synthetic eval (%s style): %s", style, metrics)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_segmenter_npz(state, out, model_cfg)
    logger.info("saved %s (%.1f MB)", out, out.stat().st_size / 2**20)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
