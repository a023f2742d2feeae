"""Train the HiCo hierarchical compressor offline → npz: the port's copy of
``scripts/train_hico.py``, on ``--device``.

    python -m gvl_tpu_torch.scripts.train_hico --out outputs/hico_params.npz \
        --steps 800 [--device cpu]

The file holds the compressor's FRAME → CLIP pool in the JAX package's flat
npz (``TemporalCompressionModule`` reads it).  ``--device`` defaults to
``cuda`` and raises without a card unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.temporal.hico import (
    HiCoConfig,
    HicoTrainConfig,
    evaluate_hico,
    save_hico_npz,
    train_hico,
)

logger = logging.getLogger("train_hico")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="outputs/hico_params.npz")
    parser.add_argument("--steps", type=int, default=800)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)

    model_cfg = HiCoConfig()
    train_cfg = HicoTrainConfig(
        steps=args.steps, batch_size=args.batch_size,
        learning_rate=args.lr, seed=args.seed)
    t0 = time.time()
    state = train_hico(model_cfg, train_cfg, device=device)
    logger.info("trained in %.1f s", time.time() - t0)

    metrics = evaluate_hico(state, model_cfg, train_cfg, device=device)
    logger.info("held-out eval: %s", metrics)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_hico_npz(state, out)
    logger.info("saved %s (%.1f MB)", out, out.stat().st_size / 2**20)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
