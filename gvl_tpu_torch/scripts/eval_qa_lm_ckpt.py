"""Grade a saved QA-LM checkpoint from disk (the port's copy of
``scripts/eval_qa_lm_ckpt.py``, on ``--device``): multi-seed held-out
accuracy on the full serving distribution, the pipeline-rendered
distribution and the short profile, written to metrics.json next to the
weights.

    python -m gvl_tpu_torch.scripts.eval_qa_lm_ckpt outputs/qa_lm --no-write [--device cpu]

``--device`` defaults to ``cuda`` and raises without a card unless
``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from gvl_tpu_torch import resolve_device

logger = logging.getLogger("eval_qa_lm_ckpt")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("ckpt", help="checkpoint dir (params.npz + config)")
    parser.add_argument("--n-samples", type=int, default=40)
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=[1234, 77, 7])
    parser.add_argument("--max-len", type=int, default=4096)
    parser.add_argument("--extra", default=None,
                        help="JSON object merged into metrics.json "
                             "(provenance fields)")
    parser.add_argument("--no-write", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    logging.getLogger("gvl_tpu_torch").setLevel(logging.WARNING)
    device = resolve_device(args.device)

    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine
    from gvl_tpu_torch.training.qa_lm_train import evaluate_qa_lm, load_qa_lm

    cfg, params = load_qa_lm(args.ckpt, device=device)
    engine = Qwen3Engine(cfg, params, eos_token_id=EOS_ID, device=device)

    def evaluate(**kw):
        out = evaluate_qa_lm(params, cfg, n_samples=args.n_samples, engine=engine, **kw)
        return {k: v for k, v in out.items() if k not in ("answers", "families")}

    full, pipe = [], []
    for seed in args.seeds:
        m = evaluate(seed=seed, max_len=args.max_len)
        logger.info("seed %d heldout: %.3f %s", seed, m["accuracy"],
                    m["by_family"])
        full.append(m)
        p = evaluate(seed=seed + 1, pipeline=True, max_len=args.max_len)
        logger.info("seed %d pipeline: %.3f %s", seed, p["accuracy"],
                    p["by_family"])
        pipe.append(p)
    short = evaluate(seed=args.seeds[0], serving_sections=False, n_events_range=(2, 6),
                     short_system=True)

    def mean(ms):
        return round(sum(m["accuracy"] for m in ms) / len(ms), 4)

    out = {
        "heldout": full[0],
        "heldout_mean_acc": mean(full),
        "heldout_by_seed": {str(s): round(m["accuracy"], 4)
                            for s, m in zip(args.seeds, full)},
        "heldout_pipeline": pipe[0],
        "pipeline_mean_acc": mean(pipe),
        "pipeline_by_seed": {str(s): round(m["accuracy"], 4)
                             for s, m in zip(args.seeds, pipe)},
        "heldout_short": short,
        "n_per_seed": args.n_samples,
    }
    if args.extra:
        out.update(json.loads(args.extra))
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, dict)}, indent=2))
    if not args.no_write:
        (Path(args.ckpt) / "metrics.json").write_text(
            json.dumps(out, indent=2))
        logger.info("wrote %s/metrics.json", args.ckpt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
