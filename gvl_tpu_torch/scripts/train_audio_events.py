"""Train the audio-event classifier on procedural audio → npz: the port's
copy of ``scripts/train_audio_events.py``, on ``--device``.

    python -m gvl_tpu_torch.scripts.train_audio_events \
        --out outputs/audio_event_params.npz [--device cpu]

The file is the JAX package's flat npz (``AudioConfig.event_checkpoint``
picks it up).  ``--device`` defaults to ``cuda`` and raises without a card
unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.audio.event_model import (
    EventModelConfig,
    evaluate_event_model,
    save_event_params,
    train_event_model,
)

logger = logging.getLogger("train_audio_events")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="outputs/audio_event_params.npz")
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pool-size", type=int, default=4096)
    parser.add_argument("--eval-samples", type=int, default=900)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)

    config = EventModelConfig()
    t0 = time.time()
    state = train_event_model(
        config, steps=args.steps, batch_size=args.batch_size,
        learning_rate=args.lr, seed=args.seed, pool_size=args.pool_size,
        log_every=200, device=device)
    logger.info("trained in %.1f s", time.time() - t0)

    metrics = evaluate_event_model(state, config, n_samples=args.eval_samples,
                                   device=device)
    logger.info("held-out synthetic eval: acc=%.3f per-class=%s",
                metrics["accuracy"], metrics["per_class_recall"])

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_event_params(state, out)
    logger.info("saved %s (%.1f MB)", out, out.stat().st_size / 2**20)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
