"""Per-sample and aggregate evaluation metrics with device-memory tracking
(the port's copy of ``benchmarks/metrics.py``).

SampleMetrics / AggregateMetrics / MetricsTracker with stage-latency
splits and comparison tables.  Peak memory reads the card's allocator
(``torch.cuda.max_memory_allocated``) where JAX reads
``memory_stats()``; the JSON keeps JAX's field names (``peak_hbm_bytes``,
``peak_hbm_gb``, ``hbm_source``).
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional

import torch

logger = logging.getLogger(__name__)


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _device_peak_bytes(device=None) -> Optional[int]:
    """The allocator's high-water mark on a CUDA ``device`` since the
    process started (``torch.cuda.max_memory_allocated``); None on the CPU
    or without a device, where nothing is read."""
    if not _on_card(device):
        return None
    return int(torch.cuda.max_memory_allocated(torch.device(device))) or None


def hbm_stat_source(device=None) -> str:
    """Which statistic :func:`_device_peak_bytes` records for ``device``:
    'allocator_peak' on a card, 'none' on the CPU."""
    return "allocator_peak" if _on_card(device) else "none"


@dataclass
class SampleMetrics:
    sample_id: str
    benchmark: str
    config_name: str
    task_type: str = "unknown"
    correct: Optional[bool] = None
    predicted: str = ""
    ground_truth: str = ""
    num_frames: int = 0
    input_tokens: int = 0
    output_tokens: int = 0
    perception_time_sec: float = 0.0
    retrieval_time_sec: float = 0.0
    generation_time_sec: float = 0.0
    total_time_sec: float = 0.0
    peak_hbm_bytes: Optional[int] = None
    error: Optional[str] = None

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class AggregateMetrics:
    config_name: str
    benchmark: str
    num_samples: int = 0
    num_correct: int = 0
    num_errors: int = 0
    accuracy: float = 0.0
    avg_frames: float = 0.0
    avg_input_tokens: float = 0.0
    avg_output_tokens: float = 0.0
    avg_perception_time: float = 0.0
    avg_retrieval_time: float = 0.0
    avg_generation_time: float = 0.0
    avg_total_time: float = 0.0
    peak_hbm_gb: float = 0.0
    # 'allocator_peak' (the card's high-water mark) or 'none' (the CPU:
    # nothing read; see metrics.hbm_stat_source)
    hbm_source: str = ""
    by_task: dict = field(default_factory=dict)

    @classmethod
    def from_samples(cls, config_name: str, benchmark: str,
                     samples: list[SampleMetrics], device=None) -> "AggregateMetrics":
        agg = cls(config_name=config_name, benchmark=benchmark,
                  num_samples=len(samples))
        if not samples:
            return agg
        scored = [s for s in samples if s.correct is not None]
        agg.num_correct = sum(1 for s in scored if s.correct)
        agg.num_errors = sum(1 for s in samples if s.error)
        agg.accuracy = agg.num_correct / len(scored) if scored else 0.0
        n = len(samples)
        agg.avg_frames = sum(s.num_frames for s in samples) / n
        agg.avg_input_tokens = sum(s.input_tokens for s in samples) / n
        agg.avg_output_tokens = sum(s.output_tokens for s in samples) / n
        agg.avg_perception_time = sum(s.perception_time_sec for s in samples) / n
        agg.avg_retrieval_time = sum(s.retrieval_time_sec for s in samples) / n
        agg.avg_generation_time = sum(s.generation_time_sec for s in samples) / n
        agg.avg_total_time = sum(s.total_time_sec for s in samples) / n
        agg.peak_hbm_gb = max(
            (s.peak_hbm_bytes or 0) for s in samples) / 1024 ** 3
        agg.hbm_source = hbm_stat_source(device)
        # per-task accuracy breakdown
        tasks: dict[str, list[SampleMetrics]] = {}
        for s in scored:
            tasks.setdefault(s.task_type, []).append(s)
        agg.by_task = {
            task: {
                "n": len(group),
                "accuracy": sum(1 for g in group if g.correct) / len(group),
            }
            for task, group in tasks.items()
        }
        return agg

    def to_dict(self) -> dict:
        return asdict(self)


class MetricsTracker:
    """start_sample → (stage timings) → end_sample → aggregates; the peak
    memory of ``device`` (a card's; None or the CPU: not read) is taken at
    every sample's end."""

    def __init__(self, output_dir: str | Path = "results", device=None):
        self.output_dir = Path(output_dir)
        self.device = device
        self._samples: dict[tuple[str, str], list[SampleMetrics]] = {}
        self._current: Optional[SampleMetrics] = None
        self._t0: float = 0.0

    # --------------------------------------------------------- per sample

    def start_sample(self, sample_id: str, benchmark: str, config_name: str,
                     task_type: str = "unknown") -> SampleMetrics:
        self._current = SampleMetrics(
            sample_id=sample_id, benchmark=benchmark,
            config_name=config_name, task_type=task_type,
        )
        self._t0 = time.perf_counter()
        return self._current

    def record_stage(self, stage: str, seconds: float) -> None:
        if self._current is None:
            return
        attr = f"{stage}_time_sec"
        if hasattr(self._current, attr):
            setattr(self._current, attr,
                    getattr(self._current, attr) + seconds)

    def end_sample(
        self,
        predicted: str = "",
        ground_truth: str = "",
        correct: Optional[bool] = None,
        num_frames: int = 0,
        input_tokens: int = 0,
        output_tokens: int = 0,
        error: Optional[str] = None,
    ) -> SampleMetrics:
        sample = self._current
        assert sample is not None, "end_sample without start_sample"
        sample.predicted = predicted
        sample.ground_truth = ground_truth
        sample.correct = correct
        sample.num_frames = num_frames
        sample.input_tokens = input_tokens
        sample.output_tokens = output_tokens
        sample.error = error
        sample.total_time_sec = time.perf_counter() - self._t0
        sample.peak_hbm_bytes = _device_peak_bytes(self.device)
        self._samples.setdefault(
            (sample.config_name, sample.benchmark), []
        ).append(sample)
        self._current = None
        return sample

    # ---------------------------------------------------------- aggregate

    def compute_aggregates(self) -> list[AggregateMetrics]:
        return [
            AggregateMetrics.from_samples(config, benchmark, samples, self.device)
            for (config, benchmark), samples in sorted(self._samples.items())
        ]

    def print_summary(self) -> None:
        for agg in self.compute_aggregates():
            print(
                f"{agg.config_name} @ {agg.benchmark}: "
                f"acc={agg.accuracy:.3f} ({agg.num_correct}/{agg.num_samples})"
                f" avg_total={agg.avg_total_time:.2f}s"
                f" peak_hbm={agg.peak_hbm_gb:.1f}GB"
            )

    def print_comparison_table(self) -> None:
        aggs = self.compute_aggregates()
        if not aggs:
            print("(no results)")
            return
        header = (f"{'config':<18} {'benchmark':<16} {'acc':>6} {'n':>5} "
                  f"{'gen_s':>7} {'total_s':>8}")
        print(header)
        print("-" * len(header))
        for agg in aggs:
            print(f"{agg.config_name:<18} {agg.benchmark:<16} "
                  f"{agg.accuracy:>6.3f} {agg.num_samples:>5} "
                  f"{agg.avg_generation_time:>7.2f} {agg.avg_total_time:>8.2f}")

    def save_results(self, experiment: str) -> Path:
        out = self.output_dir / experiment
        out.mkdir(parents=True, exist_ok=True)
        samples = [s.to_dict() for group in self._samples.values()
                   for s in group]
        (out / "samples.json").write_text(json.dumps(samples, indent=2))
        (out / "aggregates.json").write_text(json.dumps(
            [a.to_dict() for a in self.compute_aggregates()], indent=2))
        lines = []
        for agg in self.compute_aggregates():
            lines.append(
                f"{agg.config_name} @ {agg.benchmark}: acc={agg.accuracy:.3f}"
                f" n={agg.num_samples} errors={agg.num_errors}")
        (out / "summary.txt").write_text("\n".join(lines) + "\n")
        logger.info("results written to %s", out)
        return out


def create_metrics_tracker(output_dir: str = "results", device=None) -> MetricsTracker:
    return MetricsTracker(output_dir, device)
