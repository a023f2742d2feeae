"""Train the byte-level ASR model from scratch on procedural speech →
directory: the port's copy of ``scripts/train_asr.py``, on ``--device``.

    python -m gvl_tpu_torch.scripts.train_asr --out outputs/asr [--device cpu]

The directory (``params.npz``, ``asr_config.json``) is the JAX package's
(``AudioConfig.whisper_checkpoint`` reads it).  ``--device`` defaults to
``cuda`` and raises without a card unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.training.asr_train import (
    ASRTrainConfig,
    evaluate_asr,
    load_asr,
    save_asr,
    train_asr,
)

logger = logging.getLogger("train_asr")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="outputs/asr")
    parser.add_argument("--steps", type=int, default=9000)
    parser.add_argument("--batch-size", type=int, default=24)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval-samples", type=int, default=64)
    parser.add_argument("--init-from", default=None, metavar="CKPT_DIR",
                        help="warm-start from an existing asr checkpoint")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)

    cfg = ASRTrainConfig(steps=args.steps, batch_size=args.batch_size,
                         learning_rate=args.lr, seed=args.seed)
    init_params = None
    if args.init_from:
        prev_cfg, init_params = load_asr(args.init_from)
        cfg.model = prev_cfg
        logger.info("warm-starting from %s", args.init_from)

    t0 = time.time()
    state = train_asr(cfg, init_params=init_params, device=device)
    logger.info("trained in %.1f s", time.time() - t0)

    metrics = {}
    for profile in ("base", "holdout"):
        m = evaluate_asr(state, cfg.model, n_utterances=args.eval_samples,
                         profile=profile, device=device)
        metrics[profile] = m
        logger.info("%s speakers: exact=%.3f cer=%.3f wer=%.3f (n=%d)",
                    profile, m["exact_match"], m["cer"], m["wer"], m["n"])

    save_asr(state, args.out, config=cfg.model, metrics=metrics)
    logger.info("saved %s", args.out)

    # disk-verification pass in the same process (the save→load roundtrip)
    disk_cfg, disk_params = load_asr(args.out)
    disk = evaluate_asr(disk_params, disk_cfg, n_utterances=args.eval_samples,
                        profile="base", device=device)
    logger.info("disk re-eval (base): exact=%.3f cer=%.3f",
                disk["exact_match"], disk["cer"])
    metrics["disk_reeval_base"] = disk
    meta_path = Path(args.out) / "asr_config.json"
    raw = json.loads(meta_path.read_text())
    raw["metrics"] = metrics
    meta_path.write_text(json.dumps(raw, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
