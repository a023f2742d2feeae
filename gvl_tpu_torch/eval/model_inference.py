"""Full-pipeline inference for benchmark evaluation (the port's copy of
``parse_answer``, ``check_correctness`` and ``FullPipelineRunner`` of
``benchmarks/model_inference.py``, without its cross-process perception
cache).

``FullPipelineRunner`` drives the port's perception -> timeline ->
reasoning stack (:mod:`gvl_tpu_torch.pipeline`, memoized per video),
letters MCQ options, and parses free-form answers into letters / yes-no
with negation awareness.
"""

from __future__ import annotations

import logging
import re
import time
from pathlib import Path
from typing import Optional

import torch

from gvl_tpu_torch.eval.model_configs import EvalModelConfig, get_model_config
from gvl_tpu_torch.eval.samples import AnswerFormat, BenchmarkSample

logger = logging.getLogger(__name__)

# explicit yes/no phrasings; checked before bare keywords
_YES_PATTERNS = [
    r"\byes\b", r"there (is|are) (a |an )?(glitch|bug|anomal|violation)",
    r"\bglitch (is )?present\b", r"\bcontains (a |an )?(glitch|bug)\b",
]
_NO_PATTERNS = [
    r"\bno\b", r"\bnot? (a |an )?(glitch|bug|anomal|violation)",
    r"looks normal", r"nothing (unusual|wrong|abnormal)",
]
_NEGATORS = ("no ", "not ", "n't ", "without", "absence of", "never")


def parse_answer(
    response: str,
    sample: BenchmarkSample,
) -> str:
    """Free-form model text → canonical answer for scoring."""
    text = response.strip()
    if not text:
        return ""
    # prefer the **Answer:** section when present
    match = re.search(r"\*\*Answer:\*\*\s*(.+)", text, re.DOTALL)
    if match:
        text = match.group(1).strip()

    if sample.answer_format is AnswerFormat.MCQ and sample.options:
        # bare letter / "(A)" / "Answer: A"
        m = re.search(r"\b([A-H])[).:\s]", text + " ")
        if m:
            idx = ord(m.group(1)) - ord("A")
            if idx < len(sample.options):
                return sample.options[idx]
        # option text match (longest first to avoid substring confusion)
        for option in sorted(sample.options, key=len, reverse=True):
            if option.lower() in text.lower():
                return option
        return text.split("\n")[0][:100]

    if sample.answer_format is AnswerFormat.BINARY:
        lowered = text.lower()
        # negation-aware: look back ~30 chars before glitch-ish words
        for keyword in ("glitch", "bug", "anomaly", "violation"):
            for m in re.finditer(keyword, lowered):
                window = lowered[max(0, m.start() - 30): m.start()]
                if any(neg in window for neg in _NEGATORS):
                    return "No"
        if any(re.search(p, lowered) for p in _NO_PATTERNS):
            return "No"
        if any(re.search(p, lowered) for p in _YES_PATTERNS):
            return "Yes"
        return text.split("\n")[0][:50]

    return text.split("\n")[0][:200]


def check_correctness(predicted: str, sample: BenchmarkSample) -> bool:
    truth = sample.ground_truth.strip().lower()
    pred = predicted.strip().lower()
    if not truth:
        return False
    if sample.answer_format is AnswerFormat.BINARY:
        return pred.startswith(truth[:2]) or truth in pred
    if sample.answer_format is AnswerFormat.MCQ:
        if pred == truth:
            return True
        # ground truth may itself be a letter
        if len(truth) == 1 and sample.options:
            idx = ord(truth.upper()) - ord("A")
            if 0 <= idx < len(sample.options):
                return pred == sample.options[idx].strip().lower()
        return truth in pred or pred in truth
    return truth in pred


class FullPipelineRunner:
    """Runs samples through the complete perception+reasoning pipeline on
    ``device`` (``embedding_model``: the retriever's embedder, as
    :func:`gvl_tpu_torch.pipeline.process_video` takes it).

    ``process_video`` results are memoized per video path, so a benchmark
    with many questions per video pays perception once.  A sample that
    fails is answered with ``error`` set, as in JAX.
    """

    def __init__(
        self,
        eval_config: Optional[EvalModelConfig] = None,
        preset: str = "light",
        use_cache: bool = True,
        device: str | torch.device = "cuda",
        embedding_model: Optional[str] = None,
    ):
        from gvl_tpu_torch import resolve_device
        from gvl_tpu_torch.config import load_preset

        self.eval_config = eval_config or get_model_config("gvp_light")
        self.preset = load_preset(preset)
        self._apply_eval_toggles()
        self.use_cache = use_cache
        self.device = resolve_device(device)
        self.embedding_model = embedding_model
        self._processed: dict[str, object] = {}

    def _apply_eval_toggles(self) -> None:
        ec, pc = self.eval_config, self.preset
        pc.perception.use_sam = ec.use_sam
        pc.perception.use_siglip = ec.use_siglip
        pc.perception.use_ocr = ec.use_ocr
        pc.audio.use_audio = ec.use_asr
        pc.temporal.use_hico = ec.use_hico
        pc.inference.fps = ec.fps
        pc.reasoning.max_new_tokens = ec.max_new_tokens
        pc.reasoning.use_lora = ec.use_lora
        pc.reasoning.use_projectors = ec.use_projectors
        if ec.llm_checkpoint:
            pc.reasoning.llm_checkpoint = ec.llm_checkpoint
        # namespace the feature cache per ablation arm: arms differ in
        # which perception runs, so a cache entry written by one arm
        # must never be served to another
        pc.inference.cache_dir = str(
            Path(pc.inference.cache_dir) / ec.name)

    def _get_processed(self, video_path: str):
        if video_path not in self._processed:
            from gvl_tpu_torch.pipeline import process_video

            self._processed[video_path] = process_video(
                video_path, self.preset, use_cache=self.use_cache,
                device=self.device, embedding_model=self.embedding_model)
        return self._processed[video_path]

    def run_inference(self, sample: BenchmarkSample) -> dict:
        """Answer one sample; returns prediction + stage timings."""
        t_start = time.perf_counter()
        timings = {"perception": 0.0, "retrieval": 0.0, "generation": 0.0}
        video = sample.video_path or sample.image_path
        prompt = sample.get_prompt()

        if video is None:
            return {
                "predicted": "", "raw_response": "",
                "timings": timings, "num_frames": 0,
                "error": "sample has no media",
            }

        try:
            t0 = time.perf_counter()
            processed = self._get_processed(str(video))
            timings["perception"] = time.perf_counter() - t0

            from gvl_tpu_torch.pipeline import answer_query

            t0 = time.perf_counter()
            if self.eval_config.use_timeline:
                response = answer_query(processed, prompt,
                                        sample.start_time_sec)
            else:
                response = processed.loop.reasoning_core.reason(
                    prompt, timeline_indexer=None, knowledge_base=None,
                )
            timings["generation"] = time.perf_counter() - t0

            predicted = parse_answer(response or "", sample)
            return {
                "predicted": predicted,
                "raw_response": response or "",
                "timings": timings,
                "num_frames": len(processed.timestamps),
                "total_time": time.perf_counter() - t_start,
            }
        except Exception as exc:
            logger.exception("inference failed for %s", sample.sample_id)
            return {
                "predicted": "", "raw_response": "", "timings": timings,
                "num_frames": 0, "error": str(exc),
            }
