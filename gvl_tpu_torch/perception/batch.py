"""The segmenter's preset ladder (the port's copy of
``gvl_tpu.perception.batch.build_segmenter``).

The batched perception path of the JAX module (``run_batched_perception``,
chunked frames x concepts programs with shared region and OCR batches) is
not ported (ROADMAP A14).
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)


def build_segmenter(config, device: str | torch.device = "cuda"):
    """Segmenter from the preset ladder (``config`` a
    :class:`~gvl_tpu_torch.config.presets.SystemConfig`): the model on
    ``device`` when ``sam_checkpoint`` resolves ("auto"), the model always
    ("jax", seeded random weights without a checkpoint), the deterministic
    fake otherwise or for "fake".  "open_vocab" (SAM proposals scored by
    SigLIP text) is not ported (ROADMAP A6).

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
        raise NotImplementedError(
            "sam_backend='open_vocab' (SAM proposals x SigLIP text scoring) is not "
            "ported yet (ROADMAP A6)")
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
