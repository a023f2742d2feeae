"""PhysGame loader (880 physics-violation gameplay videos).

The port's copy of ``benchmarks/loaders/physgame.py``: four
physical domains with per-domain categories; MCQ options synthesized from
the domain when the annotation lacks them.
"""

from __future__ import annotations

import logging
from pathlib import Path

from gvl_tpu_torch.eval.loaders.base import (
    AnswerFormat,
    BenchmarkConfig,
    BenchmarkLoader,
    BenchmarkSample,
    TaskType,
)

logger = logging.getLogger(__name__)

DOMAINS = {
    "mechanics": ["gravity", "collision", "velocity", "acceleration"],
    "kinematics": ["motion", "rotation", "trajectory"],
    "optics": ["reflection", "shadow", "transparency"],
    "material": ["deformation", "penetration", "fluid"],
}

DEFAULT_QUESTION = (
    "What physical-law violation occurs in this gameplay video?"
)


def synthesize_options(domain: str, correct: str) -> list[str]:
    """MCQ distractors drawn from the domain's category list."""
    categories = DOMAINS.get(domain, ["gravity", "collision", "motion"])
    options = [correct] + [c for c in categories if c != correct][:3]
    while len(options) < 4:
        options.append("no violation")
    return options[:4]


class PhysGameLoader(BenchmarkLoader):
    name = "physgame"

    def _load_samples(self) -> list[BenchmarkSample]:
        root = Path(self.config.data_dir or "data/benchmarks/physgame")
        ann = (Path(self.config.annotation_file)
               if self.config.annotation_file else root / "annotations.json")
        if not ann.exists():
            return []
        samples = []
        for i, row in enumerate(self._load_json_annotations(ann)):
            domain = row.get("class", row.get("domain", "mechanics"))
            subcategory = row.get("subclass", row.get("category", ""))
            options = row.get("options") or synthesize_options(
                domain, row.get("answer", subcategory or "gravity"))
            video = row.get("video") or row.get("video_path")
            if video and not str(video).startswith(("/", "synthetic://")):
                video = str(root / "videos" / video)
            samples.append(BenchmarkSample(
                sample_id=str(row.get("id", f"pg_{i:04d}")),
                benchmark_name=self.name,
                video_path=video,
                question=row.get("question", DEFAULT_QUESTION),
                options=list(options),
                ground_truth=str(row.get("answer", options[0])),
                task_type=TaskType.PHYSICS_VIOLATION,
                answer_format=AnswerFormat.MCQ,
                category=domain,
                subcategory=subcategory,
                video_duration_sec=row.get("duration"),
            ))
        return samples


def create_physgame_loader(
    data_dir: str = "data/benchmarks/physgame", **kw
) -> PhysGameLoader:
    return PhysGameLoader(BenchmarkConfig(data_dir=data_dir, **kw))
