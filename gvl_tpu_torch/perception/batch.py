"""Throughput-oriented batched perception and the preset ladders of the
segmenter and the semantic encoder (the port's copy of
:mod:`gvl_tpu.perception.batch`).

:func:`run_batched_perception` processes a clip in chunks with a fixed,
small number of device calls per chunk:

- segmentation: one ``[frames x concepts]`` forward per chunk, submitted
  one chunk ahead (``backend.submit`` / ``collect``; the upload is
  page-locked on a card, so the host does not wait for the previous
  chunk's forward to queue the next);
- region semantics: all regions of the chunk in shared bucket-padded
  batches (:meth:`SigLIPSemanticEncoder.encode_regions_multi`), one
  whole-frame batch for the frames with no region;
- OCR: one :meth:`OCRPipeline.extract_batch` per chunk;

then feeds the timeline and knowledge base as the sequential path does.
The stage-parallel alternative is :mod:`gvl_tpu_torch.parallel.pipeline`.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

DEFAULT_CONCEPTS = ["player", "enemy", "boss", "item"]


def run_batched_perception(
    frames: Sequence[tuple[float, np.ndarray]],
    config,
    timeline,
    kb,
    concepts: Sequence[str] = DEFAULT_CONCEPTS,
    chunk: int = 32,
    segmenter=None,
    encoder=None,
    ocr=None,
    device: str | torch.device = "cuda",
) -> list[tuple[float, np.ndarray]]:
    """Full visual perception over ``frames`` (``[(timestamp, HxWx3
    uint8)]``) → per-timestamp semantic embeddings; ``timeline`` and ``kb``
    are fed in place.  ``config`` is a
    :class:`~gvl_tpu_torch.config.presets.SystemConfig`; pre-built
    ``segmenter`` / ``encoder`` / ``ocr`` are reused, the others built from
    it on ``device``.

    Segmentation runs one chunk ahead: chunk ``i+1``'s forward is queued
    on the card before chunk ``i``'s host work (mask NMS, tracking, region
    preparation, timeline and KB ingest), so the card computes while the
    host consumes.
    """
    from gvl_tpu_torch.fusion import EventPriority, ModalityType

    if segmenter is None or encoder is None or ocr is None:
        built = build_perception_stack(config, device=device)
        segmenter = segmenter or built[0]
        encoder = encoder or built[1]
        ocr = ocr or built[2]

    p = config.perception
    sam_step = max(1, int(round(config.inference.fps / max(p.sam3_fps, 1e-6))))

    # chunk groups up front, so segmentation can run one chunk ahead
    groups = []
    for start in range(0, len(frames), chunk):
        group = frames[start:start + chunk]
        indices = list(range(start, start + len(group)))
        groups.append({
            "indices": indices,
            "stamps": [ts for ts, _ in group],
            "images": [f for _, f in group],
            "sampled": [(pos, idx) for pos, idx in enumerate(indices)
                        if idx % sam_step == 0] if p.use_sam else [],
        })

    backend = getattr(segmenter, "backend", None)
    can_pipeline = p.use_sam and backend is not None and hasattr(backend, "submit")

    def submit_seg(g):
        if can_pipeline and g["sampled"]:
            g["seg_handle"] = backend.submit(
                [g["images"][pos] for pos, _ in g["sampled"]], list(concepts))

    if groups:
        submit_seg(groups[0])

    out: list[tuple[float, np.ndarray]] = []
    for gi, g in enumerate(groups):
        if gi + 1 < len(groups):
            submit_seg(groups[gi + 1])    # the card works ahead
        indices, stamps, images = g["indices"], g["stamps"], g["images"]
        sampled = g["sampled"]

        # segmentation + tracking: one frames x concepts forward
        per_frame_entities: list[list] = [[] for _ in indices]
        if p.use_sam and sampled:
            sample_frames = [images[pos] for pos, _ in sampled]
            sample_indices = [idx for _, idx in sampled]
            if "seg_handle" in g:
                raw = backend.collect(g["seg_handle"], sample_frames, sample_indices,
                                      list(concepts))
                batch_entities = segmenter.ingest_raw(raw, sample_indices, list(concepts))
            else:
                batch_entities = segmenter.segment_batch(sample_frames, sample_indices,
                                                         list(concepts))
            for (pos, idx), entities in zip(sampled, batch_entities):
                per_frame_entities[pos] = entities
                timeline.add_from_sam_entities(entities, idx, stamps[pos])
                kb.update_from_tracking(entities, idx, stamps[pos])

        # region semantics: every region of the chunk in shared batches
        if p.use_siglip:
            frame_masks = []
            for pos, idx in enumerate(indices):
                masks = []
                for entity in per_frame_entities[pos]:
                    m = entity.get_mask_at_frame(idx)
                    if m is not None:
                        masks.append((entity.entity_id, m.mask))
                frame_masks.append((images[pos], masks))
            region_embs = encoder.encode_regions_multi(frame_masks)
            # whole-frame embeddings for frames with no region, batched too
            bare = [pos for pos, embs in enumerate(region_embs) if not embs]
            bare_embs = encoder.encode_images_batch([images[pos] for pos in bare])
            for pos, embs in enumerate(region_embs):
                for emb in embs:
                    out.append((stamps[pos], emb.embedding))
            for j, pos in enumerate(bare):
                out.append((stamps[pos], bare_embs[j]))

        # OCR: one batched call per chunk
        if p.use_ocr:
            for result in ocr.extract_batch(images, indices, stamps):
                for det in result.detections:
                    if det.confidence < 0.7 or len(det.text) < 3:
                        continue
                    important = det.category in ("damage", "health")
                    timeline.add_event(
                        result.timestamp, ModalityType.OCR, det.text,
                        priority=(EventPriority.MEDIUM if important
                                  else EventPriority.LOW),
                        confidence=det.confidence,
                        metadata={"category": det.category, "bbox": det.bbox},
                    )
    out.sort(key=lambda pair: pair[0])
    return out


def build_segmenter(config, device: str | torch.device = "cuda"):
    """Segmenter from the preset ladder (``config`` a
    :class:`~gvl_tpu_torch.config.presets.SystemConfig`): the model on
    ``device`` when ``sam_checkpoint`` resolves ("auto"), the model always
    ("jax", seeded random weights without a checkpoint), the deterministic
    fake otherwise or for "fake".  "open_vocab" takes the trained
    composite (segmenter proposals named by the mini-SigLIP,
    :mod:`gvl_tpu_torch.perception.open_vocab`) when ``sam_checkpoint`` and
    a mini-SigLIP ``siglip_checkpoint`` resolve; HF directories
    (``sam_vit_dir``) raise (ROADMAP A10); with neither it falls back to
    "auto", as in JAX.

    Unlike the JAX package (ROADMAP C7), a checkpoint that resolves but
    cannot be read, or whose geometry is not the model's, raises: the arm
    does not segment with random weights in its place.  Without a
    checkpoint (none set, or the file absent) "auto" takes the fake, as in
    JAX.
    """
    from gvl_tpu_torch.perception.segmenter import (
        SAMConceptSegmenter,
        SAMConfig,
        TorchSegmenterBackend,
        _checkpoint_state,
    )
    from gvl_tpu_torch.utils.checkpoints import resolve_repo_path

    p = config.perception
    backend = getattr(p, "sam_backend", "auto")
    if backend == "open_vocab":
        from gvl_tpu_torch.training.siglip_train import is_minisiglip_checkpoint

        sam_dir = resolve_repo_path(getattr(p, "sam_vit_dir", None))
        siglip_dir = resolve_repo_path(getattr(p, "siglip_checkpoint", None))
        seg_ckpt = resolve_repo_path(getattr(p, "sam_checkpoint", None))
        if siglip_dir and is_minisiglip_checkpoint(siglip_dir) and seg_ckpt:
            from gvl_tpu_torch.perception.open_vocab import (
                create_trained_open_vocab_segmenter,
            )

            return create_trained_open_vocab_segmenter(seg_ckpt, siglip_dir, device=device)
        if sam_dir and siglip_dir:
            from gvl_tpu_torch.perception.open_vocab import create_open_vocab_segmenter

            return create_open_vocab_segmenter(sam_dir, siglip_dir)
        logger.warning(
            "sam_backend='open_vocab' needs sam_vit_dir + siglip_checkpoint HF "
            "directories (or sam_checkpoint + a trained mini-SigLIP dir); falling "
            "back to 'auto'")
        backend = "auto"
    ckpt = resolve_repo_path(getattr(p, "sam_checkpoint", None))
    if backend == "jax" or (backend == "auto" and ckpt):
        seg_config = SAMConfig()
        state = None
        if ckpt:
            try:
                state = _checkpoint_state(ckpt, seg_config.image_size)
            except Exception as exc:
                raise ValueError(
                    f"segmenter checkpoint {ckpt} cannot be used ({exc}); the JAX "
                    "package would segment with random weights here (ROADMAP C7)") from exc
        return SAMConceptSegmenter(seg_config, backend=TorchSegmenterBackend(
            seg_config, state=state, device=device))
    return SAMConceptSegmenter(SAMConfig())


def build_siglip_encoder(config, device: str | torch.device = "cuda"):
    """Semantic encoder from the preset ladder: the trained mini-SigLIP
    (:meth:`SigLIPSemanticEncoder.from_trained_checkpoint`, its own f32
    numerics; ``siglip_int8`` gives its dynamic W8A8 blocks) when
    ``siglip_checkpoint`` is one, an HF checkpoint otherwise (not ported,
    ROADMAP A10), the so400m tower on seeded random weights for
    ``siglip_backend="jax"`` (the fused W8A8 tower when ``siglip_fused``),
    the deterministic fake for "fake" or without a checkpoint."""
    from gvl_tpu_torch.perception.semantic import NaFlexConfig, SigLIPSemanticEncoder
    from gvl_tpu_torch.training.siglip_train import is_minisiglip_checkpoint
    from gvl_tpu_torch.utils.checkpoints import resolve_repo_path

    p = config.perception
    backend = getattr(p, "siglip_backend", "auto")
    if backend == "fake":     # explicit fake always wins
        return SigLIPSemanticEncoder()
    nf = NaFlexConfig(quant_int8=True) if getattr(p, "siglip_int8", False) else None

    def _fused(cfg):
        # the fused W8A8 tower serves the big (so400m / HF) towers; an
        # explicit siglip_int8 picks the plain int8 path over it
        if getattr(p, "siglip_fused", False) and not (cfg is not None and cfg.quant_int8):
            cfg = cfg or NaFlexConfig()
            cfg.quant_fused = True
        return cfg

    ckpt = resolve_repo_path(getattr(p, "siglip_checkpoint", None))
    if ckpt:
        if is_minisiglip_checkpoint(ckpt):
            return SigLIPSemanticEncoder.from_trained_checkpoint(ckpt, config=nf,
                                                                 device=device)
        return SigLIPSemanticEncoder.from_hf_checkpoint(ckpt, config=_fused(nf))
    if backend == "jax":
        return SigLIPSemanticEncoder.with_random_tower(config=_fused(nf), device=device)
    return SigLIPSemanticEncoder()


def build_perception_stack(config, device: str | torch.device = "cuda"):
    """(segmenter, encoder, ocr) from the preset's ladders, on ``device``."""
    from gvl_tpu_torch.perception.ocr import create_ocr_pipeline

    return (build_segmenter(config, device=device),
            build_siglip_encoder(config, device=device),
            create_ocr_pipeline(config.perception.ocr_backend, device=device))
