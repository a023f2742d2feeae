"""Train the OCR recognizer and detector on synthetic HUD text → npz: the
port's copy of ``scripts/train_ocr.py``, on ``--device``.

    python -m gvl_tpu_torch.scripts.train_ocr --out outputs/ocr_params.npz [--device cpu]

Rendering the training text needs Pillow.  The file is the JAX package's
(``OCRConfig(backend='jax', checkpoint=...)`` and ``TorchOCREngine`` read
it).  ``--device`` defaults to ``cuda`` and raises without a card unless
``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.perception.ocr_model import (
    OCRModelConfig,
    evaluate_recognizer,
    save_ocr_params,
    train_detector,
    train_recognizer,
)

logger = logging.getLogger("train_ocr")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="outputs/ocr_params.npz")
    parser.add_argument("--rec-steps", type=int, default=12000)
    parser.add_argument("--det-steps", type=int, default=2000)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--arch", default="v2", choices=["crnn", "v2"],
                        help="recognizer architecture (v2 = conv + transformer context)")
    parser.add_argument("--pool-size", type=int, default=30000,
                        help="pre-rendered crop pool (0 = render every batch)")
    parser.add_argument("--fonts", dest="fonts", action="store_true", default=True,
                        help="combined clean+multifont curriculum (default)")
    parser.add_argument("--no-fonts", dest="fonts", action="store_false",
                        help="default PIL font only")
    parser.add_argument("--distractors", dest="distractors", action="store_true",
                        default=True,
                        help="detector curriculum: noisy backgrounds + entity-shaped "
                             "clutter (default)")
    parser.add_argument("--no-distractors", dest="distractors", action="store_false")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)

    config = OCRModelConfig(rec_arch=args.arch)
    t0 = time.time()
    logger.info("training %s recognizer (%d steps, charset %d chars)",
                args.arch, args.rec_steps, len(config.charset))
    rec = train_recognizer(
        config, steps=args.rec_steps, batch_size=args.batch_size,
        learning_rate=args.lr, seed=args.seed, log_every=500,
        use_fonts=args.fonts, pool_size=args.pool_size, device=device)
    logger.info("training detector (%d steps, distractors=%s)",
                args.det_steps, args.distractors)
    det = train_detector(
        config, steps=args.det_steps, batch_size=8, learning_rate=args.lr,
        seed=args.seed + 1, log_every=250, distractors=args.distractors,
        use_fonts=args.fonts, device=device)
    for fonts in (False, True):
        metrics = evaluate_recognizer(rec, config, use_fonts=fonts, device=device)
        logger.info("held-out exact match (%s): %s",
                    "multi-font" if fonts else "default font", metrics)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_ocr_params({"detector": det, "recognizer": rec}, str(out), config)
    logger.info("saved %s (%.0fs total); use with "
                "OCRConfig(backend='jax', checkpoint=%r)",
                out, time.time() - t0, str(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
