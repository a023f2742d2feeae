"""The segmenter's and the semantic encoder's preset ladders (the port's
copies of ``build_segmenter`` and ``build_siglip_encoder`` of
``gvl_tpu.perception.batch``).

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
