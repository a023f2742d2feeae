"""On-screen text extraction (HUD, damage numbers, dialogs): the port's
copy of :mod:`gvl_tpu.perception.ocr`.

Host-side pipeline with pluggable engines: the port's det/rec engine
(:class:`~gvl_tpu_torch.perception.ocr_model.TorchOCREngine`, backend
"jax" or "native" as in the JAX package, or "torch") on the card; the
``tesseract`` engine (:class:`TesseractOCR`) for "auto" and "tesseract"
when the binary and ``pytesseract`` are installed; else
:class:`DeterministicFakeOCR`, which makes stable HUD-style detections
from the frame's content.
"""

from __future__ import annotations

import hashlib
import logging
import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


@dataclass
class TextDetection:
    text: str
    confidence: float
    bbox: tuple[float, float, float, float]  # x1, y1, x2, y2
    category: Optional[str] = None


@dataclass
class OCRFrame:
    frame_idx: int
    timestamp: float
    detections: list[TextDetection] = field(default_factory=list)
    processing_time_ms: float = 0.0

    def get_by_category(self, category: str) -> list[TextDetection]:
        return [d for d in self.detections if d.category == category]

    @property
    def all_text(self) -> str:
        return " ".join(d.text for d in self.detections)


@dataclass
class OCRConfig:
    lang: str = "en"
    det_db_thresh: float = 0.3
    det_db_box_thresh: float = 0.5
    min_confidence: float = 0.5
    enable_caching: bool = True
    max_cache_size: int = 100
    frame_skip_similarity: float = 0.95
    roi_regions: Optional[list[tuple[float, float, float, float]]] = None
    backend: str = "auto"  # "auto" | "tesseract" | "jax" | "native" | "torch" | "fake"
    # the JAX package's OCR checkpoint (used by the "jax" backend;
    # random weights + a warning without it)
    checkpoint: Optional[str] = None


class TextCategorizer:
    """Heuristic HUD-text categories (reference rules)."""

    PATTERNS = {
        "damage": lambda t: t.isdigit() and len(t) <= 6,
        "health": lambda t: any(h in t.lower() for h in ("hp", "health", "/")),
        "level": lambda t: "lv" in t.lower() or "level" in t.lower(),
        "time": lambda t: ":" in t and any(c.isdigit() for c in t),
        "currency": lambda t: any(c in t for c in ("$", "gold", "coins")),
    }

    def categorize(self, text: str, bbox: tuple) -> Optional[str]:
        text = text.strip()
        if not text:
            return None
        for category, rule in self.PATTERNS.items():
            try:
                if rule(text):
                    return category
            except Exception:
                continue
        return "general"


class FrameCache:
    """LRU-ish cache keyed by an 8x-downsampled frame hash."""

    def __init__(self, max_size: int = 100):
        self.max_size = max_size
        self._cache: dict[str, OCRFrame] = {}
        self._order: list[str] = []

    @staticmethod
    def _key(frame: np.ndarray) -> str:
        return hashlib.md5(frame[::8, ::8].tobytes()).hexdigest()

    def get(self, frame: np.ndarray) -> Optional[OCRFrame]:
        return self._cache.get(self._key(frame))

    def set(self, frame: np.ndarray, result: OCRFrame) -> None:
        key = self._key(frame)
        if key in self._cache:
            return
        while len(self._cache) >= self.max_size:
            del self._cache[self._order.pop(0)]
        self._cache[key] = result
        self._order.append(key)

    def clear(self) -> None:
        self._cache.clear()
        self._order.clear()


class DeterministicFakeOCR:
    """Stable HUD-style detections derived from frame content."""

    _HUD = ("HP 100/100", "MP 50/50", "LV 12", "1250", "12:34", "350 gold")

    def __call__(self, frame: np.ndarray) -> list[tuple[str, float, tuple]]:
        digest = hashlib.blake2b(frame[::16, ::16].tobytes(),
                                 digest_size=8).digest()
        rng = np.random.default_rng(int.from_bytes(digest, "little"))
        n = int(rng.integers(1, 4))
        h, w = frame.shape[:2]
        out = []
        for i in range(n):
            text = self._HUD[int(rng.integers(0, len(self._HUD)))]
            x1 = float(rng.uniform(0, w * 0.7))
            y1 = float(rng.uniform(0, h * 0.8))
            out.append((text, float(rng.uniform(0.7, 0.99)),
                        (x1, y1, x1 + 80, y1 + 20)))
        return out


class TesseractOCR:
    """pytesseract/tesseract-binary engine (host-side)."""

    def __init__(self, lang: str = "eng"):
        self.lang = lang

    def __call__(self, frame: np.ndarray) -> list[tuple[str, float, tuple]]:
        import pytesseract
        from PIL import Image

        data = pytesseract.image_to_data(
            Image.fromarray(frame), lang=self.lang,
            output_type=pytesseract.Output.DICT,
        )
        out = []
        for text, conf, x, y, w, h in zip(
            data["text"], data["conf"], data["left"], data["top"],
            data["width"], data["height"],
        ):
            text = text.strip()
            if not text or float(conf) < 0:
                continue
            out.append((text, float(conf) / 100.0,
                        (float(x), float(y), float(x + w), float(y + h))))
        return out


def _resolve_engine(config: OCRConfig, device: str | torch.device = "cuda") -> Callable:
    if config.backend == "fake":
        return DeterministicFakeOCR()
    if config.backend in ("jax", "native", "torch"):
        # "native": the shipped synthetic-HUD checkpoint; fake when it is missing
        checkpoint = config.checkpoint
        if checkpoint is None and config.backend == "native":
            default = Path(__file__).resolve().parents[2] / "outputs" / "ocr_params.npz"
            if default.exists():
                checkpoint = str(default)
            else:
                logger.warning("native OCR requested but %s missing; using fake OCR",
                               default)
                return DeterministicFakeOCR()
        from gvl_tpu_torch.perception.ocr_model import TorchOCREngine

        return TorchOCREngine(checkpoint=checkpoint, device=device)
    wants_tesseract = config.backend in ("auto", "tesseract")
    if wants_tesseract and shutil.which("tesseract") is not None:
        try:
            import pytesseract  # noqa: F401

            return TesseractOCR("eng" if config.lang == "en" else config.lang)
        except ImportError:
            pass
    if config.backend == "tesseract":
        logger.warning("tesseract requested but unavailable; using fake OCR")
    return DeterministicFakeOCR()


class OCRPipeline:
    """Frame → categorized text detections, with caching and ROI support.

    >>> ocr = OCRPipeline()
    >>> result = ocr.extract_text_from_frame(frame, 0, 0.0)
    >>> [(d.text, d.category) for d in result.detections]
    """

    def __init__(
        self,
        config: Optional[OCRConfig] = None,
        engine: Optional[Callable] = None,
        device: str | torch.device = "cuda",
    ):
        self.config = config or OCRConfig()
        self.engine = engine or _resolve_engine(self.config, device)
        self.categorizer = TextCategorizer()
        self.cache = FrameCache(self.config.max_cache_size)

    def extract_text_from_frame(
        self, frame: np.ndarray, frame_idx: int, timestamp: float
    ) -> OCRFrame:
        if self.config.enable_caching:
            cached = self.cache.get(frame)
            if cached is not None:
                return OCRFrame(
                    frame_idx=frame_idx, timestamp=timestamp,
                    detections=cached.detections,
                    processing_time_ms=0.0,
                )
        t0 = time.perf_counter()
        regions = self._crop_rois(frame)
        detections: list[TextDetection] = []
        for crop, (ox, oy) in regions:
            for text, conf, bbox in self.engine(crop):
                if conf < self.config.min_confidence:
                    continue
                shifted = (bbox[0] + ox, bbox[1] + oy,
                           bbox[2] + ox, bbox[3] + oy)
                detections.append(TextDetection(
                    text=text, confidence=conf, bbox=shifted,
                    category=self.categorizer.categorize(text, shifted),
                ))
        result = OCRFrame(
            frame_idx=frame_idx, timestamp=timestamp, detections=detections,
            processing_time_ms=(time.perf_counter() - t0) * 1e3,
        )
        if self.config.enable_caching:
            self.cache.set(frame, result)
        return result

    def _crop_rois(self, frame: np.ndarray):
        if not self.config.roi_regions:
            return [(frame, (0.0, 0.0))]
        h, w = frame.shape[:2]
        crops = []
        for rx1, ry1, rx2, ry2 in self.config.roi_regions:
            x1, y1 = int(rx1 * w), int(ry1 * h)
            x2, y2 = int(rx2 * w), int(ry2 * h)
            crops.append((frame[y1:y2, x1:x2], (float(x1), float(y1))))
        return crops

    def extract_batch(
        self, frames: list[np.ndarray], frame_indices: list[int],
        timestamps: list[float],
    ) -> list[OCRFrame]:
        """Many frames, few device dispatches (engines exposing
        ``.batch``, e.g. the det/rec engine); per-frame fallback
        otherwise.  ROI cropping multiplies the batch, not the calls.
        Shares the frame-hash cache with the per-frame path: repeated
        (static HUD) frames are served from cache, only misses batched."""
        if not hasattr(self.engine, "batch"):
            return [self.extract_text_from_frame(f, i, t)
                    for f, i, t in zip(frames, frame_indices, timestamps)]
        t0 = time.perf_counter()
        cached: dict[int, OCRFrame] = {}
        misses: list[int] = []
        if self.config.enable_caching:
            for fi, frame in enumerate(frames):
                hit = self.cache.get(frame)
                if hit is not None:
                    cached[fi] = hit
                else:
                    misses.append(fi)
        else:
            misses = list(range(len(frames)))
        crops, offsets, owners = [], [], []
        for fi in misses:
            for crop, origin in self._crop_rois(frames[fi]):
                crops.append(crop)
                offsets.append(origin)
                owners.append(fi)
        raw = self.engine.batch(crops) if crops else []
        per_frame: dict[int, list[TextDetection]] = {fi: [] for fi in misses}
        for dets, (ox, oy), fi in zip(raw, offsets, owners):
            for text, conf, bbox in dets:
                if conf < self.config.min_confidence:
                    continue
                shifted = (bbox[0] + ox, bbox[1] + oy,
                           bbox[2] + ox, bbox[3] + oy)
                per_frame[fi].append(TextDetection(
                    text=text, confidence=conf, bbox=shifted,
                    category=self.categorizer.categorize(text, shifted),
                ))
        ms = (time.perf_counter() - t0) * 1e3 / max(len(misses), 1)
        out: list[OCRFrame] = []
        for fi, (i, t) in enumerate(zip(frame_indices, timestamps)):
            if fi in cached:
                result = OCRFrame(frame_idx=i, timestamp=t,
                                  detections=cached[fi].detections,
                                  processing_time_ms=0.0)
            else:
                result = OCRFrame(frame_idx=i, timestamp=t,
                                  detections=per_frame[fi],
                                  processing_time_ms=ms)
                if self.config.enable_caching:
                    self.cache.set(frames[fi], result)
            out.append(result)
        return out

    def extract_from_video_frames(
        self, frames: list[np.ndarray], fps: float, skip_frames: int = 1
    ) -> list[OCRFrame]:
        kept = [(i, f) for i, f in enumerate(frames) if not i % skip_frames]
        return self.extract_batch(
            [f for _, f in kept], [i for i, _ in kept],
            [i / fps for i, _ in kept])

    # ------------------------------------------------------------- analysis

    @staticmethod
    def get_text_timeline(
        ocr_frames: list[OCRFrame],
    ) -> list[tuple[float, str, str]]:
        timeline = [
            (f.timestamp, d.text, d.category or "unknown")
            for f in ocr_frames for d in f.detections
        ]
        timeline.sort(key=lambda x: x[0])
        return timeline

    @staticmethod
    def find_text_by_category(
        ocr_frames: list[OCRFrame], category: str
    ) -> list[TextDetection]:
        out = []
        for frame in ocr_frames:
            out.extend(frame.get_by_category(category))
        return out

    @staticmethod
    def track_text_changes(
        ocr_frames: list[OCRFrame], text_pattern: str
    ) -> list[tuple[float, str]]:
        """(timestamp, text) each time the first matching value changes."""
        changes: list[tuple[float, str]] = []
        last = None
        for frame in ocr_frames:
            for det in frame.detections:
                if text_pattern.lower() in det.text.lower():
                    if det.text != last:
                        changes.append((frame.timestamp, det.text))
                        last = det.text
                    break
        return changes


def create_ocr_pipeline(
    backend: str = "auto", config: Optional[OCRConfig] = None,
    device: str | torch.device = "cuda",
) -> OCRPipeline:
    config = config or OCRConfig()
    config.backend = backend
    return OCRPipeline(config, device=device)
