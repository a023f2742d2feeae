"""Generic JSON-benchmark runner with a mock mode and preset comparison (the
port's copy of ``benchmarks/eval_harness.py``, with ``--device``).

Runs any benchmark in the unified JSON schema, supports ``--mock``
(random-choice inference, for harness validation), per-category accuracy,
preset comparison, and an example-benchmark generator.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
from pathlib import Path

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.eval.loaders.base import (
    AnswerFormat,
    BenchmarkConfig,
    BenchmarkLoader,
    BenchmarkSample,
    TaskType,
)
from gvl_tpu_torch.eval.metrics import create_metrics_tracker
from gvl_tpu_torch.eval.model_inference import FullPipelineRunner, check_correctness

logger = logging.getLogger(__name__)


class JsonBenchmarkLoader(BenchmarkLoader):
    """Loads the unified-schema JSON produced by generate_example_benchmark."""

    name = "json_benchmark"

    def __init__(self, path: str, config: BenchmarkConfig | None = None):
        super().__init__(config)
        self.path = Path(path)
        self.name = self.path.stem

    def _load_samples(self) -> list[BenchmarkSample]:
        rows = self._load_json_annotations(self.path)
        out = []
        for i, row in enumerate(rows):
            out.append(BenchmarkSample(
                sample_id=str(row.get("sample_id", f"s{i:04d}")),
                benchmark_name=self.name,
                video_path=row.get("video_path"),
                image_path=row.get("image_path"),
                question=row.get("question", ""),
                options=row.get("options", []),
                ground_truth=str(row.get("ground_truth", "")),
                task_type=TaskType(row.get("task_type", "visual_qa")),
                answer_format=AnswerFormat(row.get("answer_format",
                                                   "free_text")),
                category=row.get("category", "general"),
            ))
        return out


def generate_example_benchmark(path: Path, n: int = 10,
                               seed: int = 0) -> None:
    """Write a runnable example benchmark over synthetic videos."""
    rng = random.Random(seed)
    samples = []
    for i in range(n):
        duration = rng.choice([10, 20])
        samples.append({
            "sample_id": f"example_{i:04d}",
            "video_path": f"synthetic://example_{i}?duration={duration}&fps=2",
            "question": "Is there a visible entity moving in this video?",
            "options": ["Yes", "No"],
            "ground_truth": "Yes",
            "task_type": "visual_qa",
            "answer_format": "binary",
            "category": rng.choice(["combat", "exploration"]),
        })
    path.write_text(json.dumps({"samples": samples}, indent=2))
    logger.info("wrote %d example samples to %s", n, path)


def mock_inference(sample: BenchmarkSample, rng: random.Random) -> str:
    if sample.options:
        return rng.choice(sample.options)
    return "mock answer"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--benchmark", default=None,
                        help="path to a unified-schema JSON benchmark")
    parser.add_argument("--generate-example", default=None,
                        help="write an example benchmark to this path")
    parser.add_argument("--n", type=int, default=10)
    parser.add_argument("--mock", action="store_true",
                        help="random-choice inference (harness check)")
    parser.add_argument("--preset", default="light",
                        choices=["light", "standard", "full"])
    parser.add_argument("--compare-presets", nargs="*", default=None)
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--output-dir", default="results")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "PyTorch path)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)

    if args.generate_example:
        generate_example_benchmark(Path(args.generate_example), args.n)
        if not args.benchmark:
            return 0

    if not args.benchmark:
        parser.error("--benchmark (or --generate-example) required")

    loader = JsonBenchmarkLoader(
        args.benchmark, BenchmarkConfig(max_samples=args.max_samples))
    tracker = create_metrics_tracker(args.output_dir, device)
    rng = random.Random(0)

    presets = args.compare_presets or [args.preset]
    for preset in presets:
        runner = (None if args.mock
                  else FullPipelineRunner(preset=preset, device=device))
        config_name = f"{'mock' if args.mock else 'pipeline'}_{preset}"
        for sample in loader:
            tracker.start_sample(sample.sample_id, loader.name, config_name,
                                 task_type=sample.task_type.value)
            if args.mock:
                predicted = mock_inference(sample, rng)
            else:
                predicted = runner.run_inference(sample).get("predicted", "")
            tracker.end_sample(
                predicted=predicted,
                ground_truth=sample.ground_truth,
                correct=check_correctness(predicted, sample),
            )
    tracker.print_summary()
    tracker.print_comparison_table()
    tracker.save_results("eval_harness")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
