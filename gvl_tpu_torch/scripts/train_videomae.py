"""Train the VideoMAE clip classifier on procedural clips → directory: the
port's copy of ``scripts/train_videomae.py``, on ``--device``.

    python -m gvl_tpu_torch.scripts.train_videomae --out outputs/videomae [--device cpu]

The directory (``params.npz``, ``videomae_config.json``) is the JAX
package's.  ``--device`` defaults to ``cuda`` and raises without a card
unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.training.videomae_train import (
    ClipTrainConfig,
    classifier_from_state,
    evaluate_clip_encoder,
    load_clip_encoder,
    save_clip_encoder,
    train_clip_encoder,
)

logger = logging.getLogger("train_videomae")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="outputs/videomae")
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval-clips", type=int, default=160)
    parser.add_argument("--pool-batches", type=int, default=128)
    parser.add_argument("--init-from", default=None, metavar="CKPT_DIR",
                        help="warm-start from an existing checkpoint")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)

    cfg = ClipTrainConfig(steps=args.steps, batch_size=args.batch_size,
                          learning_rate=args.lr, seed=args.seed,
                          pool_batches=args.pool_batches)
    init_params = None
    if args.init_from:
        from gvl_tpu_torch.models.convert import clip_classifier_params_from_jax
        from gvl_tpu_torch.utils.checkpoints import load_flat_npz

        prev_cfg, _ = load_clip_encoder(args.init_from, device)
        cfg.model = prev_cfg
        init_params = clip_classifier_params_from_jax(
            load_flat_npz(Path(args.init_from) / "params.npz"), prev_cfg)
        logger.info("warm-starting from %s", args.init_from)

    t0 = time.time()
    state = train_clip_encoder(cfg, init_params=init_params, device=device)
    logger.info("trained in %.1f s", time.time() - t0)

    model = classifier_from_state(state, cfg.model, device)
    metrics = {}
    for style in ("base", "holdout"):
        m = evaluate_clip_encoder(model, n_clips=args.eval_clips, style=style)
        metrics[style] = m
        logger.info("%s style: dir=%.3f (moving %.3f) kind=%.3f "
                    "event=%.3f (n=%d)", style, m["direction_acc"],
                    m["direction_acc_moving"], m["kind_acc"],
                    m["event_acc"], m["n"])
    # temporal control: frame-shuffled clips must lose the motion signal
    ctrl = evaluate_clip_encoder(model, n_clips=args.eval_clips, style="base",
                                 shuffle_frames=True)
    metrics["shuffled_control"] = ctrl
    logger.info("shuffled control: dir(moving)=%.3f (chance ~0.125)",
                ctrl["direction_acc_moving"])

    save_clip_encoder(state, args.out, model_cfg=cfg.model, metrics=metrics)
    logger.info("saved %s", args.out)

    # disk re-eval (re-measure every artifact from disk before shipping)
    _, disk_model = load_clip_encoder(args.out, device)
    disk = evaluate_clip_encoder(disk_model, n_clips=args.eval_clips, style="base")
    logger.info("disk re-eval (base): dir=%.3f kind=%.3f event=%.3f",
                disk["direction_acc"], disk["kind_acc"], disk["event_acc"])
    metrics["disk_reeval_base"] = disk
    meta_path = Path(args.out) / "videomae_config.json"
    raw = json.loads(meta_path.read_text())
    raw["metrics"] = metrics
    meta_path.write_text(json.dumps(raw, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
