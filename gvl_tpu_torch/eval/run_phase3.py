"""Phase 3 evaluation: LongVideoBench + MLVU (long-horizon, 3-120 min).

The port's copy of ``benchmarks/run_phase3.py``, with ``--device`` (adds
``--min-duration`` / ``--max-duration`` filters; validates the
compression+retrieval stack's token efficiency on hour-scale videos).
"""

from __future__ import annotations

from gvl_tpu_torch.eval.loaders.longvideo import LongVideoBenchLoader, MLVULoader
from gvl_tpu_torch.eval.phase_runner import run_phase


def _extra(parser):
    parser.add_argument("--benchmark", default="all",
                        choices=["longvideobench", "mlvu", "all"])
    parser.add_argument("--min-duration", type=float, default=None)
    parser.add_argument("--max-duration", type=float, default=None)


def _config_extra(args):
    out = {}
    if args.min_duration is not None:
        out["min_duration_sec"] = args.min_duration
    if args.max_duration is not None:
        out["max_duration_sec"] = args.max_duration
    return out


def main(argv=None) -> int:
    import argparse

    peek = argparse.ArgumentParser(add_help=False)
    peek.add_argument("--benchmark", default="all")
    known, _ = peek.parse_known_args(argv)

    factories = []
    if known.benchmark in ("longvideobench", "all"):
        factories.append(lambda cfg: LongVideoBenchLoader(cfg))
    if known.benchmark in ("mlvu", "all"):
        factories.append(lambda cfg: MLVULoader(cfg))

    return run_phase(
        "phase3", __doc__, factories, argv=argv,
        extra_args=_extra, config_extra=_config_extra,
    )


if __name__ == "__main__":
    raise SystemExit(main())
