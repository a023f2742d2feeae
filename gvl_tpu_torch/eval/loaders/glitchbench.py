"""GlitchBench loader (CVPR 2024, 593 confirmed game glitches).

The port's copy of ``benchmarks/loaders/glitchbench.py``:
HF-parquet path with embedded image extraction, JSON-annotation fallback,
directory-scan fallback, default binary yes/no options.
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

DEFAULT_QUESTION = (
    "Is there a glitch, bug, or visual anomaly in this game footage? "
    "Answer Yes or No and explain."
)


class GlitchBenchLoader(BenchmarkLoader):
    name = "glitchbench"

    def _load_samples(self) -> list[BenchmarkSample]:
        root = Path(self.config.data_dir or "data/benchmarks/glitchbench")
        samples: list[BenchmarkSample] = []

        # 1. HF parquet snapshots with embedded image bytes
        for parquet in sorted(root.glob("**/*.parquet")):
            samples.extend(self._from_parquet(parquet, root))
        if samples:
            return samples

        # 2. JSON annotations
        ann = (Path(self.config.annotation_file)
               if self.config.annotation_file
               else root / "annotations.json")
        if ann.exists():
            for i, row in enumerate(self._load_json_annotations(ann)):
                samples.append(self._make_sample(
                    row.get("id", f"gb_{i:04d}"),
                    image_path=row.get("image") or row.get("image_path"),
                    video_path=row.get("video") or row.get("video_path"),
                    question=row.get("question", DEFAULT_QUESTION),
                    ground_truth=row.get("answer", row.get("ground_truth", "Yes")),
                    category=row.get("category", row.get("game", "general")),
                    description=row.get("description"),
                ))
            return samples

        # 3. directory scan: every image is a confirmed glitch ⇒ truth "Yes"
        image_dir = root / "images"
        if image_dir.exists():
            for i, img in enumerate(sorted(image_dir.glob("*"))):
                if img.suffix.lower() not in (".png", ".jpg", ".jpeg"):
                    continue
                samples.append(self._make_sample(
                    f"gb_scan_{i:04d}", image_path=str(img),
                    question=DEFAULT_QUESTION, ground_truth="Yes",
                ))
        return samples

    def _from_parquet(self, parquet: Path, root: Path) -> list[BenchmarkSample]:
        import pandas as pd

        out = []
        frame = pd.read_parquet(parquet)
        image_dir = root / "images"
        image_dir.mkdir(parents=True, exist_ok=True)
        for i, row in frame.iterrows():
            image_path = None
            image_cell = row.get("image")
            if isinstance(image_cell, dict) and "bytes" in image_cell:
                image_path = image_dir / f"{parquet.stem}_{i:05d}.png"
                if not image_path.exists():
                    image_path.write_bytes(image_cell["bytes"])
                image_path = str(image_path)
            out.append(self._make_sample(
                str(row.get("id", f"{parquet.stem}_{i:05d}")),
                image_path=image_path,
                question=str(row.get("question", DEFAULT_QUESTION)),
                ground_truth=str(row.get("answer", "Yes")),
                category=str(row.get("game", "general")),
                description=(str(row["description"])
                             if "description" in row else None),
            ))
        return out

    def _make_sample(self, sample_id: str, **kw) -> BenchmarkSample:
        options = kw.pop("options", None) or ["Yes", "No"]
        return BenchmarkSample(
            sample_id=sample_id,
            benchmark_name=self.name,
            options=options,
            task_type=TaskType.GLITCH_DETECTION,
            answer_format=AnswerFormat.BINARY,
            **kw,
        )


def create_glitchbench_loader(
    data_dir: str = "data/benchmarks/glitchbench", **kw
) -> GlitchBenchLoader:
    return GlitchBenchLoader(BenchmarkConfig(data_dir=data_dir, **kw))
