"""Open-vocabulary concept segmentation and persistent entity tracking
(the port's copy of :mod:`gvl_tpu.perception.segmenter`).

Host-side tracking over per-frame detections from a pluggable backend:

- :class:`TorchSegmenterBackend`: the promptable segmenter
  (:mod:`gvl_tpu_torch.models.sam`) on the card, every frame × concept in
  one call, masks thresholded there and read back as bools;
- :class:`DeterministicFakeSegmenter`: hash-seeded drifting boxes.

Entity lifecycle ACTIVE → OCCLUDED → LOST → TERMINATED, as the JAX
package's (terminate checked before the lost transition).
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

import numpy as np
import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.parallel.collectives import gather_batch, split_batch
from gvl_tpu_torch.runtime.native import resize_images, resize_mask

logger = logging.getLogger(__name__)


class EntityState(Enum):
    ACTIVE = "active"
    OCCLUDED = "occluded"
    LOST = "lost"
    TERMINATED = "terminated"


@dataclass
class BoundingBox:
    x_min: float
    y_min: float
    x_max: float
    y_max: float

    @property
    def center(self) -> tuple[float, float]:
        return ((self.x_min + self.x_max) / 2, (self.y_min + self.y_max) / 2)

    @property
    def area(self) -> float:
        return (self.x_max - self.x_min) * (self.y_max - self.y_min)

    @property
    def width(self) -> float:
        return self.x_max - self.x_min

    @property
    def height(self) -> float:
        return self.y_max - self.y_min

    def to_xyxy(self) -> tuple[float, float, float, float]:
        return (self.x_min, self.y_min, self.x_max, self.y_max)


@dataclass
class SegmentationMask:
    mask: np.ndarray          # bool [H, W]
    confidence: float
    bbox: BoundingBox
    area_pixels: int

    @classmethod
    def from_logits(cls, logits: np.ndarray, threshold: float = 0.0):
        """Binarize logits; confidence = mean sigmoid."""
        mask = np.asarray(logits) > threshold
        ys, xs = np.where(mask)
        bbox = (
            BoundingBox(float(xs.min()), float(ys.min()),
                        float(xs.max()), float(ys.max()))
            if len(xs) else BoundingBox(0, 0, 0, 0)
        )
        confidence = float(1.0 / (1.0 + np.exp(-np.asarray(logits))).mean())
        return cls(mask=mask, confidence=confidence, bbox=bbox,
                   area_pixels=int(mask.sum()))

    @classmethod
    def from_bbox(cls, bbox_xyxy, shape: tuple[int, int], confidence: float):
        """Rectangular mask from an xyxy box (fake/detector backends)."""
        x1, y1, x2, y2 = (int(round(v)) for v in bbox_xyxy)
        h, w = shape
        x1, x2 = max(0, x1), min(w, x2)
        y1, y2 = max(0, y1), min(h, y2)
        mask = np.zeros((h, w), bool)
        mask[y1:y2, x1:x2] = True
        return cls(mask=mask, confidence=confidence,
                   bbox=BoundingBox(float(x1), float(y1), float(x2), float(y2)),
                   area_pixels=int(mask.sum()))


@dataclass
class TrackedEntity:
    entity_id: str
    concept_label: str
    first_seen_frame: int
    last_seen_frame: int
    state: EntityState = EntityState.ACTIVE
    confidence: float = 0.0
    frame_masks: dict[int, SegmentationMask] = field(default_factory=dict)
    state_history: list[tuple[int, EntityState]] = field(default_factory=list)
    attributes: dict = field(default_factory=dict)

    def update(self, frame_idx: int, mask: SegmentationMask,
               state: Optional[EntityState] = None) -> None:
        self.frame_masks[frame_idx] = mask
        self.last_seen_frame = frame_idx
        self.confidence = mask.confidence
        if state and state is not self.state:
            self.state = state
            self.state_history.append((frame_idx, state))

    def get_trajectory(self) -> list[tuple[int, tuple[float, float]]]:
        return [(f, m.bbox.center) for f, m in sorted(self.frame_masks.items())]

    def get_mask_at_frame(self, frame_idx: int) -> Optional[SegmentationMask]:
        return self.frame_masks.get(frame_idx)

    @property
    def duration_frames(self) -> int:
        return self.last_seen_frame - self.first_seen_frame + 1


@dataclass
class SAMConfig:
    """Thresholds and tracking patience (reference defaults)."""

    model_name: str = "gvl/sam3-tpu"
    dtype: str = "bfloat16"       # compute dtype; master weights stay fp32
    mask_threshold: float = 0.0
    min_mask_area: int = 100
    nms_threshold: float = 0.7
    detection_threshold: float = 0.3
    track_memory_frames: int = 30
    occlusion_patience: int = 10
    lost_patience: int = 30
    match_iou_threshold: float = 0.3
    image_size: int = 256


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    if a.shape != b.shape:
        return 0.0
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(a, b).sum() / union)


class DeterministicFakeSegmenter:
    """Hash-seeded detector: one drifting box per concept.

    The box's base position derives from the concept hash; it drifts
    smoothly with frame index, so cross-frame IoU stays high and the
    tracker exercises real matching.
    """

    def __init__(self, config: SAMConfig):
        self.config = config

    def __call__(
        self, frames: np.ndarray, concepts: list[str], frame_indices: list[int]
    ) -> list[list[list[dict]]]:
        out = []
        for frame, frame_idx in zip(frames, frame_indices):
            h, w = frame.shape[:2]
            per_frame = []
            for concept in concepts:
                digest = hashlib.blake2b(concept.encode(), digest_size=8).digest()
                rng = np.random.default_rng(int.from_bytes(digest, "little"))
                cx = float(rng.uniform(0.25, 0.75)) * w + 3.0 * frame_idx
                cy = float(rng.uniform(0.25, 0.75)) * h
                size = float(rng.uniform(0.12, 0.25)) * min(h, w)
                cx = min(max(cx, size), w - size)
                bbox = (cx - size, cy - size, cx + size, cy + size)
                mask = SegmentationMask.from_bbox(bbox, (h, w), confidence=0.9)
                per_frame.append([{"mask": mask}])
            out.append(per_frame)
        return out


class TorchSegmenterBackend:
    """The promptable segmenter on ``device``: frames × concepts in one
    forward.  ``state`` is the model's state dict (``None``: random
    weights from ``generator``, seed 0 by default, where the JAX backend
    draws from ``PRNGKey(0)``).  ``mesh``: data-parallel segmentation, the
    frames padded to a multiple of the ``data`` size and split over it,
    each replica running its block, the masks and scores gathered so that
    every rank returns every frame's detections."""

    def __init__(self, config: SAMConfig, state: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None,
                 device: str | torch.device = "cuda", mesh=None):
        from gvl_tpu_torch.models.sam import PromptableSegmenter, SamConfig, hash_tokenize
        from gvl_tpu_torch.nn.layers import init_state, load_module

        self.device = resolve_device(device)
        self.config = config
        self.model_config = SamConfig(image_size=config.image_size)
        with torch.device("meta"):
            model = PromptableSegmenter(self.model_config)
        if state is None:
            state = init_state(model, generator or torch.Generator(self.device).manual_seed(0),
                               self.device)
        self.model = load_module(model, state, self.device)
        self._hash_tokenize = hash_tokenize
        self.mesh = mesh

    @torch.inference_mode()
    def submit(self, frames, concepts):
        """Host resize, upload and the forward, queued on the card without
        waiting for it: returns a handle for :meth:`collect`, so the caller
        can track the previous chunk meanwhile."""
        size = self.config.image_size
        # one native call for a clip's frames (they share a shape)
        resized, n_real = split_batch(resize_images(frames, size, size), self.mesh)
        tokens = np.stack([self._hash_tokenize(c, self.model_config.text_vocab)
                           for c in concepts])
        # uint8 over the link, normalised on the card; page-locked on a
        # card, so the upload queues behind the card's work instead of
        # holding the host until the previous chunk has run
        px, ids = torch.from_numpy(resized), torch.from_numpy(tokens)
        if self.device.type == "cuda":
            px, ids = px.pin_memory(), ids.pin_memory()
        px = px.to(self.device, non_blocking=True).float() / 255.0
        out = self.model(px, ids.to(self.device, non_blocking=True))
        # thresholded on the card: bool masks come back at 1 byte a cell
        mask = out["mask_logits"] > float(self.config.mask_threshold)
        return {"mask": gather_batch(mask, self.mesh, n_real),
                "scores": gather_batch(out["scores"], self.mesh, n_real)}, n_real

    def collect(self, handle, frames, frame_indices, concepts):
        """Wait for the card's result and run the host-side mask NMS."""
        out, n_real = handle
        small_masks = out["mask"].cpu().numpy()[:n_real]
        scores = out["scores"].float().cpu().numpy()[:n_real]

        results = []
        for fi, (frame, frame_idx) in enumerate(zip(frames, frame_indices)):
            h, w = frame.shape[:2]
            per_frame = []
            for ci in range(len(concepts)):
                # score-ordered mask NMS at the decode resolution: several
                # queries typically fire on the same instance
                order = np.argsort(-scores[fi, ci])
                kept_small: list[np.ndarray] = []
                dets = []
                for qi in order:
                    if scores[fi, ci, qi] < self.config.detection_threshold:
                        continue
                    small = small_masks[fi, ci, qi]
                    area = small.sum()
                    if not area:
                        continue
                    dup = any(
                        (small & k).sum() / max((small | k).sum(), 1)
                        > self.config.nms_threshold
                        for k in kept_small
                    )
                    if dup:
                        continue
                    kept_small.append(small)
                    mask = resize_mask(small, h, w)
                    ys, xs = np.where(mask)
                    bbox = (
                        BoundingBox(float(xs.min()), float(ys.min()),
                                    float(xs.max()), float(ys.max()))
                        if len(xs) else BoundingBox(0, 0, 0, 0)
                    )
                    dets.append({"mask": SegmentationMask(
                        mask=mask, confidence=float(scores[fi, ci, qi]),
                        bbox=bbox, area_pixels=int(mask.sum()),
                    )})
                per_frame.append(dets)
            results.append(per_frame)
        return results

    def __call__(self, frames, concepts, frame_indices):
        return self.collect(self.submit(frames, concepts),
                            frames, frame_indices, concepts)


class SAMConceptSegmenter:
    """Text-prompted segmentation with persistent entity tracking.

    >>> segmenter = SAMConceptSegmenter()
    >>> for idx, frame in enumerate(frames):
    ...     entities = segmenter.segment_with_prompts(frame, idx, ["boss"])
    """

    def __init__(
        self,
        config: Optional[SAMConfig] = None,
        backend: Optional[Callable] = None,
    ):
        self.config = config or SAMConfig()
        self.backend = backend or DeterministicFakeSegmenter(self.config)
        self._tracked_entities: dict[str, TrackedEntity] = {}
        self._entity_counter: dict[str, int] = {}
        self._current_frame = 0

    # ------------------------------------------------------------ tracking

    def _generate_entity_id(self, concept_label: str) -> str:
        normalized = concept_label.lower().replace(" ", "_")
        count = self._entity_counter.get(normalized, 0)
        self._entity_counter[normalized] = count + 1
        return f"{normalized}_{count:03d}"

    def _match_detection_to_entity(
        self, mask: SegmentationMask, concept_label: str, frame_idx: int
    ) -> Optional[TrackedEntity]:
        """Best same-concept entity by mask IoU within the memory window.

        Exact bbox pre-gate: a mask lives inside its bbox, so disjoint
        bboxes imply mask IoU 0 — the full-resolution pixel IoU (the
        measured host hot spot at 48-frame chunks) only runs for
        candidates whose boxes actually overlap."""
        best, best_iou = None, 0.0
        box = mask.bbox
        for entity in self._tracked_entities.values():
            if entity.concept_label != concept_label:
                continue
            if entity.state is EntityState.TERMINATED:
                continue
            if frame_idx - entity.last_seen_frame > self.config.track_memory_frames:
                continue
            last_mask = entity.get_mask_at_frame(entity.last_seen_frame)
            if last_mask is None:
                continue
            other = last_mask.bbox
            if (box.x_max <= other.x_min or other.x_max <= box.x_min
                    or box.y_max <= other.y_min or other.y_max <= box.y_min):
                continue   # disjoint boxes → mask IoU is exactly 0
            iou = mask_iou(mask.mask, last_mask.mask)
            if iou > best_iou and iou > self.config.match_iou_threshold:
                best, best_iou = entity, iou
        return best

    def _update_entity_states(self, frame_idx: int) -> None:
        """Age out unseen entities.  (Reference bug fixed: terminate is
        checked before the lost transition so it is actually reachable.)"""
        for entity in self._tracked_entities.values():
            if entity.state is EntityState.TERMINATED:
                continue
            gap = frame_idx - entity.last_seen_frame
            if gap > self.config.lost_patience:
                if entity.state is EntityState.LOST:
                    entity.state = EntityState.TERMINATED
                    entity.state_history.append(
                        (frame_idx, EntityState.TERMINATED))
            elif gap > self.config.occlusion_patience:
                if entity.state is EntityState.OCCLUDED:
                    entity.state = EntityState.LOST
                    entity.state_history.append((frame_idx, EntityState.LOST))
            elif gap > 0 and entity.state is EntityState.ACTIVE:
                entity.state = EntityState.OCCLUDED
                entity.state_history.append((frame_idx, EntityState.OCCLUDED))

    # ------------------------------------------------------------- segment

    def segment_with_prompts(
        self,
        frame: np.ndarray,
        frame_idx: int,
        concept_prompts: list[str],
    ) -> list[TrackedEntity]:
        """Segment one frame (see :meth:`segment_batch` for the fast path)."""
        return self.segment_batch([frame], [frame_idx], concept_prompts)[0]

    def segment_batch(
        self,
        frames: list[np.ndarray],
        frame_indices: list[int],
        concept_prompts: list[str],
    ) -> list[list[TrackedEntity]]:
        """Batched path: ONE backend call for all frames × concepts, then
        sequential tracking over frames."""
        raw = self.backend(np.stack(frames), concept_prompts, frame_indices)
        return self.ingest_raw(raw, frame_indices, concept_prompts)

    def ingest_raw(
        self,
        raw: list,                       # [frame][concept][det] dicts
        frame_indices: list[int],
        concept_prompts: list[str],
    ) -> list[list[TrackedEntity]]:
        """Tracking over pre-computed backend detections (the host half
        of :meth:`segment_batch`; lets callers pipeline the device half
        via ``backend.submit``/``backend.collect``)."""
        all_results = []
        for frame_pos, frame_idx in enumerate(frame_indices):
            self._current_frame = frame_idx
            detected: list[TrackedEntity] = []
            for concept_pos, concept in enumerate(concept_prompts):
                for det in raw[frame_pos][concept_pos]:
                    seg_mask: SegmentationMask = det["mask"]
                    if seg_mask.area_pixels < self.config.min_mask_area:
                        continue
                    matched = self._match_detection_to_entity(
                        seg_mask, concept, frame_idx
                    )
                    if matched is not None:
                        matched.update(frame_idx, seg_mask, EntityState.ACTIVE)
                        detected.append(matched)
                    else:
                        entity_id = self._generate_entity_id(concept)
                        entity = TrackedEntity(
                            entity_id=entity_id,
                            concept_label=concept,
                            first_seen_frame=frame_idx,
                            last_seen_frame=frame_idx,
                            confidence=seg_mask.confidence,
                        )
                        entity.frame_masks[frame_idx] = seg_mask
                        entity.state_history.append(
                            (frame_idx, EntityState.ACTIVE))
                        self._tracked_entities[entity_id] = entity
                        detected.append(entity)
            self._update_entity_states(frame_idx)
            all_results.append(detected)
        return all_results

    # --------------------------------------------------------------- query

    def get_entity(self, entity_id: str) -> Optional[TrackedEntity]:
        return self._tracked_entities.get(entity_id)

    def get_active_entities(self) -> list[TrackedEntity]:
        return [e for e in self._tracked_entities.values()
                if e.state is EntityState.ACTIVE]

    def get_all_entities(self) -> list[TrackedEntity]:
        return list(self._tracked_entities.values())

    def get_statistics(self) -> dict:
        by_state: dict[str, int] = {}
        for entity in self._tracked_entities.values():
            by_state[entity.state.value] = by_state.get(entity.state.value, 0) + 1
        return {
            "total_entities": len(self._tracked_entities),
            "entities_by_state": by_state,
            "current_frame": self._current_frame,
        }

    def reset(self) -> None:
        self._tracked_entities.clear()
        self._entity_counter.clear()
        self._current_frame = 0


def _checkpoint_state(checkpoint, image_size: int) -> dict:
    """The checkpoint's state dict; raises unless its tree holds exactly
    the model's parameters at the model's shapes."""
    from gvl_tpu_torch.models.convert import sam_params_from_jax
    from gvl_tpu_torch.models.sam import PromptableSegmenter, SamConfig, load_segmenter_npz

    loaded = load_segmenter_npz(checkpoint)
    model_config = SamConfig(image_size=image_size)
    with torch.device("meta"):
        expected = PromptableSegmenter(model_config).state_dict()
    state = sam_params_from_jax(loaded, model_config)

    def leaves(node):
        return sum(leaves(v) for v in node.values()) if isinstance(node, dict) else 1

    if (leaves(loaded) != len(expected) or state.keys() != expected.keys()
            or any(state[k].shape != v.shape for k, v in expected.items())):
        raise ValueError("checkpoint geometry mismatch")
    return state


def create_sam_segmenter(
    config: Optional[SAMConfig] = None,
    use_model: bool = False,
    checkpoint: Optional[str] = None,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> SAMConceptSegmenter:
    """Factory: the model backend on ``device`` when asked for (or given a
    checkpoint), the deterministic fake otherwise.  ``mesh`` enables
    data-parallel segmentation over its ``data`` axis.

    As in the JAX package, a checkpoint that cannot be read or whose
    geometry differs from the model's is NOT an error: a warning is
    logged and the backend runs on random weights (ROADMAP C7).
    """
    config = config or SAMConfig()
    backend = None
    if use_model or checkpoint:
        state = None
        if checkpoint:
            try:
                state = _checkpoint_state(checkpoint, config.image_size)
            except Exception as exc:
                logger.warning("segmenter checkpoint %s unusable (%s); random init",
                               checkpoint, exc)
        backend = TorchSegmenterBackend(config, state=state, generator=generator,
                                        device=device, mesh=mesh)
    return SAMConceptSegmenter(config, backend=backend)
