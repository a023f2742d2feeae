"""Phase 2 evaluation: VideoGameQA-Bench (9 QA/bug-report tasks).

The port's copy of ``benchmarks/run_phase2.py``, with ``--device`` (adds
``--task`` / ``--all-tasks`` filters).
"""

from __future__ import annotations

from gvl_tpu_torch.eval.loaders.videogameqa import VideoGameQALoader
from gvl_tpu_torch.eval.phase_runner import run_phase


def _extra(parser):
    parser.add_argument("--task", nargs="*", default=None,
                        help="filter to specific task files")
    parser.add_argument("--all-tasks", action="store_true")


def _config_extra(args):
    tasks = None if getattr(args, "all_tasks", False) else args.task
    return {"tasks": tasks} if tasks else {}


def main(argv=None) -> int:
    return run_phase(
        "phase2", __doc__, [lambda cfg: VideoGameQALoader(cfg)],
        argv=argv, extra_args=_extra, config_extra=_config_extra,
    )


if __name__ == "__main__":
    raise SystemExit(main())
