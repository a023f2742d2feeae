"""Train the semantic-retrieval text embedder → directory: the port's copy
of ``scripts/train_retriever.py``, on ``--device``.

    python -m gvl_tpu_torch.scripts.train_retriever --out outputs/retriever [--device cpu]

Contrastive (query, timeline-event-description) pairs with a synonym-rich
paraphrase vocabulary; the directory (``params.npz``,
``retriever_config.json``) is the JAX package's.  ``--device`` defaults to
``cuda`` and raises without a card unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.training.retriever_train import (
    RetrieverTrainConfig,
    TrainedTextEmbedder,
    evaluate_retriever,
    load_retriever,
    save_retriever,
    train_retriever,
)

logger = logging.getLogger("train_retriever")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="outputs/retriever")
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--batch-size", type=int, default=36)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval-timelines", type=int, default=50)
    parser.add_argument("--init-from", default=None, metavar="CKPT_DIR")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)

    cfg = RetrieverTrainConfig(steps=args.steps, batch_size=args.batch_size,
                               learning_rate=args.lr, seed=args.seed)
    init_params = None
    if args.init_from:
        prev_cfg, init_params = load_retriever(args.init_from)
        cfg.model = prev_cfg
        logger.info("warm-starting from %s", args.init_from)

    t0 = time.time()
    state = train_retriever(cfg, init_params=init_params, device=device)
    logger.info("trained in %.1f s", time.time() - t0)

    trained = TrainedTextEmbedder(cfg.model, state, device=device)
    metrics = {"trained": evaluate_retriever(trained, n_timelines=args.eval_timelines)}
    # the baseline this rung must beat on paraphrase (and match on
    # lexical): the n-gram hashing embedder
    from gvl_tpu_torch.agent.retriever import HashingTextEmbedder

    metrics["hashing_baseline"] = evaluate_retriever(
        HashingTextEmbedder(256), n_timelines=args.eval_timelines)
    for name, m in metrics.items():
        logger.info("%s: paraphrase top1=%.3f top5=%.3f | lexical "
                    "top1=%.3f top5=%.3f", name, m["paraphrase_top1"],
                    m["paraphrase_top5"], m["lexical_top1"], m["lexical_top5"])

    save_retriever(state, args.out, model_cfg=cfg.model, metrics=metrics)
    logger.info("saved %s", args.out)

    # disk re-eval before shipping
    disk = evaluate_retriever(TrainedTextEmbedder.from_dir(args.out, device=device),
                              n_timelines=args.eval_timelines)
    logger.info("disk re-eval: paraphrase top1=%.3f lexical top1=%.3f",
                disk["paraphrase_top1"], disk["lexical_top1"])
    metrics["disk_reeval"] = disk
    meta_path = Path(args.out) / "retriever_config.json"
    raw = json.loads(meta_path.read_text())
    raw["metrics"] = metrics
    meta_path.write_text(json.dumps(raw, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
