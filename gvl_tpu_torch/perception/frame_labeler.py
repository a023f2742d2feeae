"""Segmenter-free zero-shot frame labels (the ``gvp_light`` grounding path;
counterpart of :mod:`gvl_tpu.perception.frame_labeler`).

Median-background motion proposals (host numpy, tight boxes) are cropped,
laid on the mini-SigLIP's canvas and named zero-shot in its image-text
space; confident winners become VISUAL timeline events with the same
``"{label} detected"`` text the segmenter path writes.  The image tower runs
on ``device`` (its attention through the flash kernel); the class text
embeddings are the mean of each caption pool's unit embeddings, computed
once.  As in JAX the pixels are rounded to bf16 and the f32 tower computes
in f32.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from gvl_tpu_torch import resolve_device

logger = logging.getLogger(__name__)

# negative classes compete with the entity concepts: a proposal only
# labels as an entity when it beats "background"/"ui" too
_NEGATIVE_CLASSES = ("background", "ui")


def _connected_bboxes(mask: np.ndarray, min_cells: int = 2,
                      max_blobs: int = 8) -> list[tuple[int, int, int, int]]:
    """4-connected components of a small bool grid → (y0, x0, y1, x1)
    cell bboxes, largest first."""
    h, w = mask.shape
    seen = np.zeros_like(mask, bool)
    blobs = []
    for sy in range(h):
        for sx in range(w):
            if not mask[sy, sx] or seen[sy, sx]:
                continue
            stack = [(sy, sx)]
            seen[sy, sx] = True
            cells = []
            while stack:
                y, x = stack.pop()
                cells.append((y, x))
                for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                    if (0 <= ny < h and 0 <= nx < w and mask[ny, nx]
                            and not seen[ny, nx]):
                        seen[ny, nx] = True
                        stack.append((ny, nx))
            if len(cells) >= min_cells:
                ys = [c[0] for c in cells]
                xs = [c[1] for c in cells]
                blobs.append((len(cells), (min(ys), min(xs), max(ys), max(xs))))
    blobs.sort(key=lambda b: -b[0])
    return [b[1] for b in blobs[:max_blobs]]


class MiniSigLIPFrameLabeler:
    """Zero-shot per-frame concept labels from a mini-SigLIP checkpoint.

    >>> labeler = MiniSigLIPFrameLabeler("outputs/minisiglip", device="cpu")
    >>> labeler.label_frames(frames)   # [[("enemy", 0.93), ...], ...]
    """

    def __init__(self, minisiglip_dir: str, concepts: Optional[Sequence[str]] = None,
                 diff_threshold: int = 60, cell: int = 8, score_threshold: float = 0.5,
                 bbox_expand: float = 0.1, max_proposals_per_frame: int = 6,
                 device: str | torch.device = "cuda"):
        from gvl_tpu_torch.perception.semantic import NaFlexConfig, RegionExtractor
        from gvl_tpu_torch.training.siglip_train import (
            CAPTIONS,
            ENTITY_CLASSES,
            byte_tokenize,
            load_minisiglip,
        )

        self.device = resolve_device(device)
        self.concepts = list(concepts or ENTITY_CLASSES)
        self.diff_threshold = diff_threshold
        self.cell = cell
        self.score_threshold = score_threshold
        self.bbox_expand = bbox_expand
        self.max_proposals = max_proposals_per_frame

        self.model, vision_cfg, text_cfg = load_minisiglip(minisiglip_dir, self.device)
        self._canvas = vision_cfg.image_size
        nc = NaFlexConfig()
        nc.region_resolution = self._canvas
        self._extractor = RegionExtractor(nc)
        self._mean = torch.tensor(nc.image_mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(nc.image_std, dtype=torch.float32, device=self.device)

        # caption-pool ensembling per class (entities + negatives): the
        # mean of normalized caption embeddings, renormalized
        self.classes = self.concepts + [c for c in _NEGATIVE_CLASSES if c in CAPTIONS]
        embs = []
        with torch.inference_mode():
            for cls_name in self.classes:
                pool = CAPTIONS.get(cls_name, (cls_name,))
                ids = torch.from_numpy(byte_tokenize(list(pool), text_cfg.max_position))
                z = self.model.encode_text(ids.to(self.device)).float().cpu().numpy().mean(0)
                embs.append(z / max(np.linalg.norm(z), 1e-9))
        self._text_emb = torch.from_numpy(np.stack(embs)).to(self.device)  # [C, D]

    @torch.inference_mode()
    def _encode(self, crops_u8: np.ndarray) -> np.ndarray:
        """uint8 crops ``[R, S, S, 3]`` → class scores ``[R, C]``."""
        from gvl_tpu_torch.ops.quant_matmul import true_div

        x = torch.from_numpy(crops_u8).to(self.device)
        pix = (true_div(x.float(), 255.0) - self._mean) / self._std
        z = self.model.encode_image(pix.to(torch.bfloat16))
        return (z.float() @ self._text_emb.T).cpu().numpy()

    # ---------------------------------------------------------- proposals

    def _proposals(self, frames: np.ndarray) -> list[list[tuple[int, int, int, int]]]:
        """Median-background motion blobs → per-frame pixel bboxes."""
        n, h, w = frames.shape[:3]
        med = np.median(frames, axis=0).astype(np.int16)
        cell = self.cell
        hc, wc = h // cell, w // cell
        out = []
        for f in frames:
            diff = np.abs(f.astype(np.int16) - med).sum(-1)
            grid = diff[: hc * cell, : wc * cell].reshape(
                hc, cell, wc, cell).max((1, 3)) > self.diff_threshold
            boxes = []
            for (cy0, cx0, cy1, cx1) in _connected_bboxes(grid, max_blobs=self.max_proposals):
                y0, x0 = cy0 * cell, cx0 * cell
                y1, x1 = min((cy1 + 1) * cell, h), min((cx1 + 1) * cell, w)
                ey = int((y1 - y0) * self.bbox_expand)
                ex = int((x1 - x0) * self.bbox_expand)
                boxes.append((max(0, y0 - ey), max(0, x0 - ex),
                              min(h, y1 + ey), min(w, x1 + ex)))
            out.append(boxes)
        return out

    # ---------------------------------------------------------------- API

    def _scores(self, frames: Sequence[np.ndarray]) -> tuple[list[int], np.ndarray]:
        """(owner frame of each proposal crop, class scores ``[R, C]``)."""
        arr = np.stack([np.asarray(f, np.uint8) for f in frames])
        crops, owners = [], []
        for fi, boxes in enumerate(self._proposals(arr)):
            for (y0, x0, y1, x1) in boxes:
                if y1 - y0 < 4 or x1 - x0 < 4:
                    continue
                prepared, _ = self._extractor.prepare(arr[fi, y0:y1, x0:x1], self._canvas)
                crops.append(np.asarray(prepared, np.uint8))
                owners.append(fi)
        if not crops:
            return owners, np.zeros((0, len(self.classes)), np.float32)
        n = len(crops)
        bucket = next((b for b in (4, 8, 16, 32) if n <= b), -(-n // 32) * 32)
        batch = np.stack(crops + [np.zeros_like(crops[0])] * (bucket - n))
        return owners, self._encode(batch)[:n]

    def label_frames(self, frames: Sequence[np.ndarray]) -> list[list[tuple[str, float]]]:
        """[(concept, confidence)] per frame: confident zero-shot wins on
        motion-proposal crops; per-concept max within a frame."""
        if not len(frames):
            return []
        owners, scores = self._scores(frames)
        n_concepts = len(self.concepts)
        best: list[dict] = [dict() for _ in frames]
        for r in range(len(owners)):
            ci = int(scores[r].argmax())
            if ci >= n_concepts:
                continue  # background / ui
            s = float(scores[r, ci])
            if s < self.score_threshold:
                continue
            concept = self.concepts[ci]
            best[owners[r]][concept] = max(best[owners[r]].get(concept, 0.0), s)
        return [sorted(labels.items(), key=lambda kv: -kv[1]) for labels in best]


def emit_zero_shot_labels(frames, config, timeline,
                          concepts: Optional[Sequence[str]] = None,
                          labeler: Optional[MiniSigLIPFrameLabeler] = None,
                          device: str | torch.device = "cuda") -> int:
    """Run the labeler at the segmenter rate and add VISUAL events.

    Returns the number of events emitted; emits nothing, as the JAX
    package does, when no mini-SigLIP checkpoint resolves (the
    fake-encoder regime)."""
    from gvl_tpu_torch.fusion import ModalityType
    from gvl_tpu_torch.utils.checkpoints import resolve_repo_path

    if labeler is None:
        ckpt = resolve_repo_path(getattr(config.perception, "siglip_checkpoint", None))
        if not ckpt:
            return 0
        from gvl_tpu_torch.training.siglip_train import is_minisiglip_checkpoint

        if not is_minisiglip_checkpoint(ckpt):
            return 0
        labeler = _cached_labeler(str(ckpt), tuple(concepts or ()), device)

    step = max(1, int(round(config.inference.fps
                            / max(config.perception.sam3_fps, 1e-6))))
    sampled = [(ts, frame) for i, (ts, frame) in enumerate(frames) if i % step == 0]
    if not sampled:
        return 0
    per_frame = labeler.label_frames([f for _, f in sampled])
    emitted = 0
    for (ts, _), labels in zip(sampled, per_frame):
        for concept, conf in labels:
            timeline.add_event(
                timestamp=ts,
                modality=ModalityType.VISUAL,
                description=f"{concept} detected",
                entity_id=f"zs_{concept}",
                confidence=conf,
                metadata={"source": "zero_shot"},
            )
            emitted += 1
    return emitted


_LABELER_CACHE: dict = {}


def _cached_labeler(ckpt: str, concepts: tuple,
                    device: str | torch.device = "cuda") -> MiniSigLIPFrameLabeler:
    key = (ckpt, concepts, str(device))
    if key not in _LABELER_CACHE:
        _LABELER_CACHE[key] = MiniSigLIPFrameLabeler(
            ckpt, concepts=list(concepts) or None, device=device)
    return _LABELER_CACHE[key]
