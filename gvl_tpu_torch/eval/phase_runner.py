"""Shared phase-evaluation engine behind run_phase1/2/3 (the port's copy of
``benchmarks/phase_runner.py``).

Each phase keeps the JAX command line plus ``--device`` (default
``cuda``; raises without a card unless ``--device cpu``): an Evaluator
wiring a perception cache + metrics tracker + FullPipelineRunner, a Stage
A perception-caching pass and a Stage B per-sample loop, then aggregate
tables and JSON persistence.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Callable, Optional

import torch

from gvl_tpu_torch.eval.loaders.base import BenchmarkConfig, BenchmarkLoader
from gvl_tpu_torch.eval.metrics import MetricsTracker, create_metrics_tracker
from gvl_tpu_torch.eval.model_configs import get_model_config, list_model_configs
from gvl_tpu_torch.eval.model_inference import FullPipelineRunner, check_correctness
from gvl_tpu_torch.eval.perception_cache import PerceptionCache, create_perception_cache

logger = logging.getLogger(__name__)


class PhaseEvaluator:
    """Stage A (perception caching) + Stage B (per-sample evaluation)."""

    def __init__(
        self,
        phase_name: str,
        config_names: list[str],
        cache: Optional[PerceptionCache] = None,
        tracker: Optional[MetricsTracker] = None,
        preset: str = "light",
        output_dir: str = "results",
        device: str | torch.device = "cuda",
    ):
        from gvl_tpu_torch import resolve_device

        self.phase_name = phase_name
        self.config_names = config_names
        self.device = resolve_device(device)
        self.cache = cache or create_perception_cache()
        self.tracker = tracker or create_metrics_tracker(output_dir, self.device)
        self.preset = preset

    def _arm_cache(self, config_name: str) -> PerceptionCache:
        """Per-arm namespace: arms differ in which perception runs, so an
        artifact written with the segmenter ON must never serve an arm
        that has it off (capability transplant would invalidate the
        ablation)."""
        return PerceptionCache(self.cache.cache_dir / config_name)

    def run_perception_caching(self, loader: BenchmarkLoader,
                               runner: FullPipelineRunner,
                               config_name: str) -> int:
        """Stage A: run perception once per unique video and persist the
        REAL artifacts (embeddings npz + timeline/kb/ocr/audio JSON, the
        pinned schema) so Stage B — in this or any later process — pays
        ~zero perception time."""
        t_stage = time.perf_counter()
        videos = {s.video_path for s in loader.load() if s.video_path}
        arm_cache = runner.perception_cache or self._arm_cache(config_name)
        cached = 0
        for video in sorted(videos):
            if arm_cache.has(video):
                continue
            t0 = time.time()
            runner._get_processed(str(video))  # runs + persists artifacts
            logger.info("Stage A: %s perception %.1fs", video,
                        time.time() - t0)
            cached += 1
        logger.info("Stage A [%s]: %d/%d videos newly cached in %.3f s",
                    config_name, cached, len(videos), time.perf_counter() - t_stage)
        return cached

    def evaluate_sample(self, runner: FullPipelineRunner, sample,
                        config_name: str):
        self.tracker.start_sample(
            sample.sample_id, sample.benchmark_name, config_name,
            task_type=sample.task_type.value,
        )
        result = runner.run_inference(sample)
        for stage, secs in result.get("timings", {}).items():
            self.tracker.record_stage(stage, secs)
        predicted = result.get("predicted", "")
        correct = (
            check_correctness(predicted, sample)
            if predicted and not result.get("error") else
            (None if result.get("error") else False)
        )
        return self.tracker.end_sample(
            predicted=predicted,
            ground_truth=sample.ground_truth,
            correct=correct,
            num_frames=result.get("num_frames", 0),
            output_tokens=len(result.get("raw_response", "").split()),
            error=result.get("error"),
        )

    def run_evaluation(self, loader: BenchmarkLoader) -> None:
        samples = loader.load()
        if not samples:
            logger.warning("%s: no samples for %s", self.phase_name,
                           loader.name)
            return
        for config_name in self.config_names:
            runner = FullPipelineRunner(
                get_model_config(config_name), preset=self.preset,
                perception_cache=self._arm_cache(config_name), device=self.device,
            )
            self.run_perception_caching(loader, runner, config_name)
            for i, sample in enumerate(samples):
                metrics = self.evaluate_sample(runner, sample, config_name)
                logger.info(
                    "[%s %d/%d] %s: correct=%s (%.1fs)", config_name,
                    i + 1, len(samples), sample.sample_id, metrics.correct,
                    metrics.total_time_sec,
                )

    def finish(self) -> None:
        self.tracker.print_summary()
        self.tracker.print_comparison_table()
        self.tracker.save_results(self.phase_name)


def build_arg_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--configs", nargs="*",
                        default=["gvp_light"],
                        choices=list_model_configs())
    parser.add_argument("--preset", default="light",
                        choices=["light", "standard", "full"])
    parser.add_argument("--output-dir", default="results")
    parser.add_argument("--synthetic", action="store_true",
                        help="fabricate samples when the dataset is absent")
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "PyTorch path)")
    return parser


def loader_config_from_args(args, **extra) -> BenchmarkConfig:
    return BenchmarkConfig(
        data_dir=args.data_dir or "",
        max_samples=args.max_samples,
        synthetic=args.synthetic,
        shuffle=args.shuffle,
        random_seed=args.seed,
        **extra,
    )


def run_phase(
    phase_name: str,
    description: str,
    loader_factories: list[Callable[[BenchmarkConfig], BenchmarkLoader]],
    argv: Optional[list[str]] = None,
    extra_args: Optional[Callable[[argparse.ArgumentParser], None]] = None,
    config_extra: Optional[Callable[[argparse.Namespace], dict]] = None,
) -> int:
    parser = build_arg_parser(description)
    if extra_args:
        extra_args(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")

    evaluator = PhaseEvaluator(
        phase_name, args.configs, preset=args.preset,
        output_dir=args.output_dir, device=args.device,
    )
    extra = config_extra(args) if config_extra else {}
    for factory in loader_factories:
        loader = factory(loader_config_from_args(args, **extra))
        evaluator.run_evaluation(loader)
    evaluator.finish()
    return 0
