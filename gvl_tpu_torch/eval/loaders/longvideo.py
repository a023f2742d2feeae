"""Long-video loaders: LongVideoBench (6678 MCQ, up to 1 h) and MLVU
(3102 QA, 9 tasks, 3-120 min).

The port's copy of ``benchmarks/loaders/longvideo.py``.
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

MLVU_TASKS = {
    "plotQA": TaskType.VISUAL_QA,
    "needle": TaskType.NEEDLE_IN_HAYSTACK,
    "ego": TaskType.ACTION_RECOGNITION,
    "count": TaskType.VISUAL_QA,
    "order": TaskType.TEMPORAL_REASONING,
    "anomaly_reco": TaskType.GLITCH_DETECTION,
    "topic_reasoning": TaskType.VISUAL_QA,
    "sub_scene": TaskType.TEMPORAL_REASONING,
    "summary": TaskType.VISUAL_QA,
}


class LongVideoBenchLoader(BenchmarkLoader):
    name = "longvideobench"

    def _load_samples(self) -> list[BenchmarkSample]:
        root = Path(self.config.data_dir or "data/benchmarks/longvideobench")
        ann = (Path(self.config.annotation_file)
               if self.config.annotation_file else root / "lvb_val.json")
        if not ann.exists():
            return []
        samples = []
        for i, row in enumerate(self._load_json_annotations(ann)):
            options = row.get("candidates", row.get("options", []))
            answer = row.get("correct_choice", row.get("answer", ""))
            if isinstance(answer, int) and options:
                answer = options[answer]
            video = row.get("video_path", row.get("video_id", ""))
            if video and not str(video).startswith(("/", "synthetic://")):
                video = str(root / "videos" / video)
            samples.append(BenchmarkSample(
                sample_id=str(row.get("id", f"lvb_{i:05d}")),
                benchmark_name=self.name,
                video_path=video or None,
                question=row.get("question", ""),
                options=[str(o) for o in options],
                ground_truth=str(answer),
                task_type=TaskType.TEMPORAL_REASONING,
                answer_format=AnswerFormat.MCQ,
                category=row.get("question_category", "general"),
                video_duration_sec=row.get("duration"),
                start_time_sec=row.get("starting_timestamp_for_subtitles"),
            ))
        return samples


class MLVULoader(BenchmarkLoader):
    name = "mlvu"

    def _load_samples(self) -> list[BenchmarkSample]:
        root = Path(self.config.data_dir or "data/benchmarks/mlvu")
        if not root.exists():
            return []
        samples = []
        for task_file in sorted(root.glob("json/*.json")) or sorted(
            root.glob("*.json")
        ):
            task = task_file.stem
            task_type = next(
                (t for key, t in MLVU_TASKS.items() if key in task),
                TaskType.VISUAL_QA,
            )
            for i, row in enumerate(self._load_json_annotations(task_file)):
                options = row.get("candidates", row.get("options", []))
                video = row.get("video", "")
                if video and not str(video).startswith(("/", "synthetic://")):
                    video = str(root / "video" / video)
                samples.append(BenchmarkSample(
                    sample_id=f"mlvu_{task}_{i:05d}",
                    benchmark_name=self.name,
                    video_path=video or None,
                    question=row.get("question", ""),
                    options=[str(o) for o in options],
                    ground_truth=str(row.get("answer", "")),
                    task_type=task_type,
                    answer_format=(AnswerFormat.MCQ if options
                                   else AnswerFormat.FREE_TEXT),
                    category=task,
                    video_duration_sec=row.get("duration"),
                ))
        return samples


def create_longvideobench_loader(
    data_dir: str = "data/benchmarks/longvideobench", **kw
) -> LongVideoBenchLoader:
    return LongVideoBenchLoader(BenchmarkConfig(data_dir=data_dir, **kw))


def create_mlvu_loader(
    data_dir: str = "data/benchmarks/mlvu", **kw
) -> MLVULoader:
    return MLVULoader(BenchmarkConfig(data_dir=data_dir, **kw))
