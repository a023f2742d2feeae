"""Clip embeddings behind the preset checkpoint ladder (counterpart of
:mod:`gvl_tpu.temporal.clip_encoder`).

``build_clip_encoder``: the self-trained mini VideoMAE
(:class:`~gvl_tpu_torch.training.videomae_train.TrainedClipEncoder`, on
``device``) when ``perception.videomae_checkpoint`` resolves to one, the
deterministic hash fake when nothing resolves; an HF VideoMAE directory
raises (ROADMAP A10).  ``extract_clip_embeddings`` cuts the reference's
schedule (16-frame windows, stride 8) and, with the trained heads, writes
confident motion predictions into the timeline as TEMPORAL events.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)


class HashClipEncoder:
    """Deterministic fake: clip → mean of hash-seeded frame embeddings."""

    def __init__(self, dim: int = 768):
        from gvl_tpu_torch.temporal.hico import HashFrameEncoder

        self.dim = dim
        self._frame_encoder = HashFrameEncoder(dim)

    def encode_clip(self, clip: np.ndarray) -> np.ndarray:
        """[T, H, W, C] uint8 → [dim] float32."""
        return self._frame_encoder(clip).mean(axis=0)

    def encode_clips(self, clips: Sequence[np.ndarray]) -> np.ndarray:
        return np.stack([self.encode_clip(c) for c in clips]) \
            if clips else np.zeros((0, self.dim), np.float32)


def build_clip_encoder(config, device: str | torch.device = "cuda"):
    """Preset ladder: the self-trained mini tower when
    ``videomae_checkpoint`` is one (the default, ``outputs/videomae``); an
    HF VideoMAE directory is not ported (ROADMAP A10); the hash fake when
    nothing resolves."""
    from gvl_tpu_torch.utils.checkpoints import resolve_repo_path

    ckpt = resolve_repo_path(getattr(config.perception, "videomae_checkpoint", None))
    if ckpt:
        from gvl_tpu_torch.training.videomae_train import (
            TrainedClipEncoder,
            is_trained_clip_checkpoint,
        )

        if is_trained_clip_checkpoint(ckpt):
            logger.info("VideoMAE clip encoder: self-trained tower from %s", ckpt)
            return TrainedClipEncoder.from_dir(ckpt, device=device)
        from gvl_tpu_torch.models.videomae import load_hf_videomae

        load_hf_videomae(ckpt)
    return HashClipEncoder(768)


def extract_clip_embeddings(frames: Sequence[tuple[float, np.ndarray]], encoder,
                            clip_len: int = 16, stride: int = 8, timeline=None,
                            min_confidence: float = 0.6) -> list[tuple[float, np.ndarray]]:
    """16-frame windows at stride 8 through one batched call; with trained
    heads (``classify_clips``) and a ``timeline``, confident motion
    predictions become TEMPORAL events ("player moving right")."""
    arr = [f for _, f in frames]
    times = [t for t, _ in frames]
    starts, clips = [], []
    for start in range(0, max(1, len(arr) - clip_len + 1), stride):
        chunk = arr[start:start + clip_len]
        if not chunk:
            break
        starts.append(times[start])
        clips.append(np.stack(chunk))
    if not clips:
        return []
    embeddings = encoder.encode_clips(clips)
    if timeline is not None and hasattr(encoder, "classify_clips"):
        from gvl_tpu_torch.fusion.timeline import EventPriority, ModalityType
        from gvl_tpu_torch.training.videomae_train import DIRECTION_PHRASES

        for ts, labels in zip(starts, encoder.classify_clips(clips)):
            d_name, d_p = labels["direction"]
            k_name, k_p = labels["kind"]
            e_name, e_p = labels["event"]
            conf = min(d_p, k_p)
            if conf < min_confidence or d_name == "static":
                continue
            desc = f"{k_name} {DIRECTION_PHRASES[d_name]}"
            if e_name != "none" and e_p >= min_confidence:
                desc += f" ({e_name} mid-clip)"
            timeline.add_event(
                timestamp=float(ts), modality=ModalityType.TEMPORAL,
                description=desc, priority=EventPriority.MEDIUM,
                confidence=float(conf), metadata={"source": "clip_encoder"})
    return list(zip(starts, embeddings))
