"""Phase 1 evaluation: GlitchBench + PhysGame (glitch & physics detection).

The port's copy of ``benchmarks/run_phase1.py``, with ``--device``.
"""

from __future__ import annotations

from gvl_tpu_torch.eval.loaders.glitchbench import GlitchBenchLoader
from gvl_tpu_torch.eval.loaders.physgame import PhysGameLoader
from gvl_tpu_torch.eval.phase_runner import run_phase


def _extra(parser):
    parser.add_argument("--benchmark", default="all",
                        choices=["glitchbench", "physgame", "all"])


def main(argv=None) -> int:
    import argparse

    # peek at --benchmark to choose loaders
    peek = argparse.ArgumentParser(add_help=False)
    peek.add_argument("--benchmark", default="all")
    known, _ = peek.parse_known_args(argv)

    factories = []
    if known.benchmark in ("glitchbench", "all"):
        factories.append(lambda cfg: GlitchBenchLoader(cfg))
    if known.benchmark in ("physgame", "all"):
        factories.append(lambda cfg: PhysGameLoader(cfg))

    return run_phase(
        "phase1", __doc__, factories, argv=argv, extra_args=_extra,
    )


if __name__ == "__main__":
    raise SystemExit(main())
