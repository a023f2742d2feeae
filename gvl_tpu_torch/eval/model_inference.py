"""Full-pipeline inference for benchmark evaluation (the port's copy of
``benchmarks/model_inference.py``).

``FullPipelineRunner`` drives the port's perception -> timeline ->
reasoning stack (:mod:`gvl_tpu_torch.pipeline`, memoized per video and,
with a perception cache, across processes), letters MCQ options, and
parses free-form answers into letters / yes-no with negation awareness.
``BenchmarkModelRunner`` is the single-frame mode.
"""

from __future__ import annotations

import logging
import re
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gvl_tpu_torch.eval.loaders.base import AnswerFormat, BenchmarkSample
from gvl_tpu_torch.eval.model_configs import EvalModelConfig, get_model_config

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
    with many questions per video pays perception once (Stage A/B).  A
    sample that fails is answered with ``error`` set, as in JAX.
    """

    def __init__(
        self,
        eval_config: Optional[EvalModelConfig] = None,
        preset: str = "light",
        use_cache: bool = True,
        perception_cache=None,
        device: str | torch.device = "cuda",
        embedding_model: Optional[str] = None,
    ):
        """``perception_cache``: a :class:`~gvl_tpu_torch.eval.
        perception_cache.PerceptionCache` (already namespaced per ablation
        arm).  On a hit, Stage B rebuilds the live pipeline from the
        persisted artifacts instead of re-running perception, so the
        two-stage split works across processes."""
        from gvl_tpu_torch import resolve_device
        from gvl_tpu_torch.config import load_preset

        self.eval_config = eval_config or get_model_config("gvp_light")
        self.preset = load_preset(preset)
        self._apply_eval_toggles()
        self.use_cache = use_cache
        self.perception_cache = perception_cache
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
            from gvl_tpu_torch.eval.perception_cache import (
                load_processed_features,
                save_processed_features,
            )
            from gvl_tpu_torch.pipeline import (
                _to_cache_dict,
                process_video,
                processed_from_features,
            )

            processed = None
            if self.perception_cache is not None:
                features = load_processed_features(
                    self.perception_cache, video_path)
                if features is not None:
                    logger.info("perception-cache hit for %s", video_path)
                    processed = processed_from_features(
                        video_path, self.preset, features, device=self.device,
                        embedding_model=self.embedding_model)
            if processed is None:
                processed = process_video(
                    video_path, self.preset, use_cache=self.use_cache,
                    device=self.device, embedding_model=self.embedding_model)
                if self.perception_cache is not None:
                    save_processed_features(
                        self.perception_cache, video_path,
                        _to_cache_dict(processed))
            self._processed[video_path] = processed
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


class BenchmarkModelRunner:
    """Single-frame inference, the simplified legacy mode, on ``device``:
    decode ONE mid-video frame (or the sample's still image), run the
    segmenter on it for a "[Visual Analysis]" perception-context block,
    letter the options, and ask the reasoning core directly: no timeline,
    KB, audio, or caching.  ``FullPipelineRunner`` is the real benchmarking
    path; this arm exists for image-only datasets (GlitchBench stills) and
    quick capability probes.

    Returns ``(answer, inference_seconds)`` as the JAX runner does.  Still
    images are read with Pillow, imported only for them.
    """

    def __init__(
        self,
        preset: str = "light",
        concepts: Optional[list[str]] = None,
        llm_checkpoint: str = "",
        max_new_tokens: int = 256,
        device: str | torch.device = "cuda",
    ):
        from gvl_tpu_torch import resolve_device
        from gvl_tpu_torch.config import load_preset

        self.device = resolve_device(device)
        self.preset = load_preset(preset)
        if llm_checkpoint:
            self.preset.reasoning.llm_checkpoint = llm_checkpoint
        self.preset.reasoning.max_new_tokens = max_new_tokens
        # the trained segmenter's prompt vocabulary: the offline rung
        # detects its trained concepts
        self.concepts = concepts or ["player", "enemy", "boss", "item"]
        self._segmenter = None
        self._core = None
        self.total_samples = 0
        self.total_inference_time = 0.0

    # ------------------------------------------------------------- lazy
    def _get_segmenter(self):
        if self._segmenter is None:
            from gvl_tpu_torch.perception.batch import build_segmenter

            self._segmenter = build_segmenter(self.preset, device=self.device)
        return self._segmenter

    def _get_core(self):
        if self._core is None:
            from gvl_tpu_torch.agent.config import ReasoningCoreConfig
            from gvl_tpu_torch.agent.core import create_reasoning_core

            rc = self.preset.reasoning
            self._core = create_reasoning_core(
                config=ReasoningCoreConfig(
                    max_new_tokens=rc.max_new_tokens),
                checkpoint_path=rc.llm_checkpoint or None,
                device=self.device,
            )
        return self._core

    # --------------------------------------------------------- inference
    def _load_frame(self, sample: BenchmarkSample) -> Optional[np.ndarray]:
        """Mid-video frame or the still image, RGB uint8."""
        if sample.image_path and Path(sample.image_path).exists():
            try:
                from PIL import Image

                return np.asarray(
                    Image.open(sample.image_path).convert("RGB"))
            except Exception as exc:
                logger.warning("image decode failed for %s: %s",
                               sample.image_path, exc)
        if sample.video_path:
            from gvl_tpu_torch.io.video import extract_frames, probe_video

            try:
                meta = probe_video(str(sample.video_path))
                mid = max(meta.get("duration", 0.0) / 2.0, 0.0)
                frames = extract_frames(str(sample.video_path),
                                        fps=meta.get("fps", 1.0) or 1.0)
                if not frames:
                    return None
                return min(frames, key=lambda tf: abs(tf[0] - mid))[1]
            except Exception as exc:
                logger.warning("frame decode failed for %s: %s",
                               sample.video_path, exc)
        return None

    def _run_perception(self, frame: np.ndarray) -> tuple[str, list[dict]]:
        """Segment the frame → ("[Visual Analysis]" block, detections)."""
        descriptions, detections = [], []
        try:
            entities = self._get_segmenter().segment_with_prompts(
                frame, 0, self.concepts)
            for e in entities:
                label = getattr(e, "concept_label", "entity")
                conf = float(getattr(e, "confidence", 0.5))
                det = {"label": label, "confidence": conf}
                mask = (e.get_mask_at_frame(0)
                        if hasattr(e, "get_mask_at_frame") else None)
                if mask is not None and mask.bbox is not None:
                    bb = mask.bbox
                    det["bbox"] = [bb.x_min, bb.y_min, bb.x_max, bb.y_max]
                detections.append(det)
                descriptions.append(
                    f"- Detected: {label} (conf: {conf:.2f})")
            if not entities:
                descriptions.append("- No specific game entities detected")
        except Exception as exc:
            logger.warning("single-frame perception failed: %s", exc)
            descriptions.append("- Visual analysis unavailable")
        return "\n".join(descriptions), detections

    def run_inference(
        self, sample: BenchmarkSample,
        timeline_context: Optional[str] = None,
    ) -> tuple[str, float]:
        t0 = time.perf_counter()
        question = sample.question or sample.get_prompt()

        frame = self._load_frame(sample)
        perception_context, detections = ("", [])
        if frame is not None:
            perception_context, detections = self._run_perception(frame)

        enhanced = question
        if timeline_context:
            enhanced += f"\n\n[Timeline]\n{timeline_context}"
        if perception_context:
            enhanced += f"\n\n[Visual Analysis]\n{perception_context}"
        if sample.options and "Options:" not in enhanced:
            opts = "\n".join(f"  ({chr(65 + i)}) {o}"
                             for i, o in enumerate(sample.options))
            enhanced += (f"\n\nOptions:\n{opts}\n\n"
                         "Answer with the letter only.")

        try:
            response = self._get_core().reason(
                enhanced,
                current_frame=frame,
                region_detections=detections or None,
                track_conversation=False,
            )
        except Exception as exc:
            logger.error("single-frame inference failed: %s", exc)
            response = ""
        dt = time.perf_counter() - t0
        self.total_samples += 1
        self.total_inference_time += dt
        return parse_answer(response or "", sample), dt
