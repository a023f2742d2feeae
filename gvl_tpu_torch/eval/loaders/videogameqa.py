"""VideoGameQA-Bench loader (NeurIPS 2025, ~4786 QA across 9 tasks).

The port's copy of ``benchmarks/loaders/videogameqa.py``:
task-file discovery by filename plus a task-name → TaskType mapping.
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

TASK_MAPPING = {
    "visual_unit_test": TaskType.VISUAL_QA,
    "ui_unit_test": TaskType.VISUAL_QA,
    "glitch_detection": TaskType.GLITCH_DETECTION,
    "glitch_detection_video": TaskType.GLITCH_DETECTION,
    "parametrized_glitch_detection": TaskType.GLITCH_DETECTION,
    "bug_report": TaskType.BUG_REPORT,
    "bug_report_video": TaskType.BUG_REPORT,
    "needle_in_haystack": TaskType.NEEDLE_IN_HAYSTACK,
    "needle_in_haystack_video": TaskType.NEEDLE_IN_HAYSTACK,
}


class VideoGameQALoader(BenchmarkLoader):
    name = "videogameqa"

    def _load_samples(self) -> list[BenchmarkSample]:
        root = Path(self.config.data_dir or "data/benchmarks/videogameqa")
        if not root.exists():
            return []
        samples = []
        for task_file in sorted(root.glob("*.json")):
            task_name = task_file.stem.lower()
            task_type = TASK_MAPPING.get(task_name, TaskType.VISUAL_QA)
            if self.config.tasks and task_name not in [
                t.lower() for t in self.config.tasks
            ]:
                # task filter can name the file-level task directly
                if task_type.value not in [t.lower() for t in self.config.tasks]:
                    continue
            for i, row in enumerate(self._load_json_annotations(task_file)):
                options = row.get("options") or row.get("choices") or []
                media = row.get("video") or row.get("image") or row.get("media")
                is_video = task_name.endswith("_video") or (
                    media and str(media).endswith((".mp4", ".y4m", ".webm")))
                samples.append(BenchmarkSample(
                    sample_id=str(row.get("id", f"{task_name}_{i:05d}")),
                    benchmark_name=self.name,
                    video_path=str(root / media) if (media and is_video) else None,
                    image_path=str(root / media) if (media and not is_video) else None,
                    question=row.get("question", row.get("prompt", "")),
                    options=list(options),
                    ground_truth=str(row.get("answer",
                                             row.get("ground_truth", ""))),
                    task_type=task_type,
                    answer_format=(AnswerFormat.MCQ if options
                                   else AnswerFormat.FREE_TEXT),
                    category=task_name,
                    game_name=row.get("game"),
                    video_duration_sec=row.get("duration"),
                ))
        return samples


def create_videogameqa_loader(
    data_dir: str = "data/benchmarks/videogameqa", **kw
) -> VideoGameQALoader:
    return VideoGameQALoader(BenchmarkConfig(data_dir=data_dir, **kw))
