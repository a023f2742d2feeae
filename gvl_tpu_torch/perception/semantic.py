"""Region semantic encoding: segmentation masks → embeddings (counterpart
of :mod:`gvl_tpu.perception.semantic`).

The host extracts mask regions (bounding box widened by 10 %), resizes
them aspect-preserved onto a fixed canvas and pads the batch to a bucket;
the backend encodes the batch on the card and pools there.  Backends:
:class:`FusedSigLIPBackend` (the fused W8A8 tower and its kernels, what
the presets serve for so400m-class towers), :class:`TorchSigLIPBackend`
(the tower as plain tensor code with its attention on the flash kernel:
bf16, W8A8, or the trained f32 mini-SigLIP of
:meth:`SigLIPSemanticEncoder.from_trained_checkpoint`, which the presets'
default ``siglip_checkpoint`` serves) and :class:`DeterministicFakeBackend`
(hash-seeded, no weights).
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.siglip import (
    SigLIPVisionConfig,
    init_tower_params,
    load_tower,
    quantize_siglip_int8,
)
from gvl_tpu_torch.models.siglip_fused import prepare_fused_siglip, siglip_fused_apply
from gvl_tpu_torch.ops.quant_matmul import true_div
from gvl_tpu_torch.runtime.native import resize_image

PATCH = 14


@dataclass
class NaFlexConfig:
    """Aspect-preserving ("NaFlex") resize and encoder settings."""

    dtype: str = "bfloat16"
    base_resolution: int = 384
    # regions are small crops (HUD-scale objects): a 128 canvas costs
    # (9/27)² of the 384 canvas's patches
    region_resolution: int = 128
    min_resolution: int = 128
    max_resolution: int = 768
    embedding_dim: int = 1152
    pool_strategy: str = "mean"  # 'cls' (MAP-pooled), 'mean', 'max'
    batch_size: int = 16
    image_mean: tuple[float, float, float] = (0.5, 0.5, 0.5)
    image_std: tuple[float, float, float] = (0.5, 0.5, 0.5)
    quant_int8: bool = False     # W8A8 encoder blocks, plain tensor code
    quant_fused: bool = False    # the fused W8A8 tower on the int8 kernels


def _maybe_quantize_tower(config: SigLIPVisionConfig, state: dict,
                          naflex: NaFlexConfig):
    """(config, state) of the W8A8 tower with dynamic activation scales
    when ``quant_int8`` asks for it (``quant_fused`` builds its own)."""
    if not naflex.quant_int8 or naflex.quant_fused:
        return config, state
    return dataclasses.replace(config, quant_int8=True), quantize_siglip_int8(state)


class AspectPreservingResizer:
    """Patch-aligned target sizes that keep the aspect ratio."""

    def __init__(self, config: NaFlexConfig):
        self.config = config

    def compute_optimal_size(self, original_h: int, original_w: int) -> tuple[int, int]:
        """(target_h, target_w): aspect preserved, bounded, multiple of 14."""
        cfg = self.config
        aspect = original_w / original_h
        base = cfg.base_resolution
        if aspect >= 1:
            target_w = min(cfg.max_resolution, max(cfg.min_resolution, base))
            target_h = max(cfg.min_resolution, int(target_w / aspect))
        else:
            target_h = min(cfg.max_resolution, max(cfg.min_resolution, base))
            target_w = max(cfg.min_resolution, int(target_h * aspect))
        target_h = (target_h // PATCH) * PATCH
        target_w = (target_w // PATCH) * PATCH
        return max(PATCH, target_h), max(PATCH, target_w)

    def resize_to_canvas(self, image: np.ndarray, canvas: int) -> tuple[np.ndarray, float]:
        """Resize into a canvas x canvas frame (aspect preserved, zero pad):
        (uint8 ``[canvas, canvas, 3]``, aspect ratio)."""
        h, w = image.shape[:2]
        aspect = w / h if h else 1.0
        scale = canvas / max(h, w)
        nh = max(1, min(canvas, int(round(h * scale))))
        nw = max(1, min(canvas, int(round(w * scale))))
        resized = resize_image(np.ascontiguousarray(image), nh, nw)
        out = np.zeros((canvas, canvas, 3), dtype=np.uint8)
        out[:nh, :nw] = resized if resized.ndim == 3 else resized[..., None]
        return out, aspect


class RegionExtractor:
    """Crops mask bounding boxes (10 % expanded) out of frames."""

    def __init__(self, config: NaFlexConfig):
        self.config = config
        self.resizer = AspectPreservingResizer(config)

    def extract_masked_region(self, frame: np.ndarray, mask: np.ndarray,
                              expand_ratio: float = 0.1):
        """(cropped uint8 region, xyxy bbox).  An empty mask takes a centre
        crop."""
        ys, xs = np.where(mask)
        if len(xs) == 0:
            h, w = frame.shape[:2]
            cx, cy = w // 2, h // 2
            size = min(h, w) // 4
            bbox = (cx - size, cy - size, cx + size, cy + size)
        else:
            x_min, x_max = int(xs.min()), int(xs.max())
            y_min, y_max = int(ys.min()), int(ys.max())
            bw, bh = x_max - x_min, y_max - y_min
            bbox = (
                max(0, int(x_min - bw * expand_ratio)),
                max(0, int(y_min - bh * expand_ratio)),
                min(frame.shape[1], int(x_max + bw * expand_ratio)),
                min(frame.shape[0], int(y_max + bh * expand_ratio)),
            )
        x1, y1, x2, y2 = bbox
        return frame[y1:y2, x1:x2], bbox

    def prepare(self, region: np.ndarray, canvas_size: int | None = None):
        """Region → uint8 ``[canvas, canvas, 3]`` and its aspect ratio; the
        backends normalise on the card (1 byte a pixel crosses to it)."""
        canvas, aspect = self.resizer.resize_to_canvas(
            region, canvas_size or self.config.base_resolution)
        return canvas.astype(np.uint8), aspect


@dataclass
class SemanticEmbedding:
    """One encoded region."""

    embedding: np.ndarray
    entity_id: str
    confidence: float = 1.0
    original_bbox: Optional[tuple[int, int, int, int]] = None
    aspect_ratio: float = 1.0
    metadata: dict = field(default_factory=dict)


class DeterministicFakeBackend:
    """Hash-seeded stand-in encoder with the towers' shapes: embeddings are
    a function of the pixel bytes."""

    def __init__(self, dim: int = 1152):
        self.dim = dim

    def __call__(self, batch: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        n = batch.shape[0]
        seq = np.zeros((n, 4, self.dim), dtype=np.float32)
        for i in range(n):
            digest = hashlib.blake2b(np.ascontiguousarray(batch[i]).tobytes(),
                                     digest_size=8).digest()
            rng = np.random.default_rng(int.from_bytes(digest, "little"))
            seq[i] = rng.standard_normal((4, self.dim)).astype(np.float32)
        seq /= np.linalg.norm(seq, axis=-1, keepdims=True)
        return seq, seq.mean(axis=1)


class _TowerBackend:
    """uint8 ``[N, H, W, 3]`` batches in, pooled f32 ``[N, D]`` out: the
    batch is normalised and pooled on the card (``mean``, ``max`` or the
    MAP head for ``cls``)."""

    def __init__(self, image_mean, image_std, pool_strategy: str,
                 device: torch.device):
        self.device = device
        self.pool_strategy = pool_strategy
        self._mean = torch.tensor(image_mean, dtype=torch.float32, device=device)
        self._std = torch.tensor(image_std, dtype=torch.float32, device=device)

    def normalize(self, batch: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(batch)).to(self.device)
        if x.dtype == torch.uint8:
            x = (true_div(x.float(), 255.0) - self._mean) / self._std
        return x.to(dtype)

    def pooled(self, out: dict) -> np.ndarray:
        seq = out["last_hidden_state"]
        if self.pool_strategy == "mean":
            pooled = seq.mean(1)
        elif self.pool_strategy == "max":
            pooled = seq.amax(1)
        else:
            pooled = out["pooled"]
        return pooled.float().cpu().numpy()


class TorchSigLIPBackend(_TowerBackend):
    """The tower as plain tensor code (bf16, or the dynamic W8A8 tower):
    the counterpart of ``JaxSigLIPBackend`` and the companion the fused
    tower is held to."""

    def __init__(self, tower, dtype: str = "bfloat16", image_mean=(0.5, 0.5, 0.5),
                 image_std=(0.5, 0.5, 0.5), pool_strategy: str = "mean"):
        super().__init__(image_mean, image_std, pool_strategy,
                         next(tower.parameters()).device)
        self.tower = tower
        self._dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    @torch.inference_mode()
    def __call__(self, batch: np.ndarray) -> tuple[None, np.ndarray]:
        """(None, pooled): pooling already happened on the card.  The batch
        is rounded to the backend's type and the tower computes in the
        promoted type of that and its weights, as Flax promotes: an f32
        tower (the trained mini-SigLIP) runs bf16-rounded pixels in f32."""
        x = self.normalize(batch, self._dtype)
        x = x.to(torch.promote_types(x.dtype, next(self.tower.parameters()).dtype))
        out = self.tower(x, pool=self.pool_strategy == "cls")
        return None, self.pooled(out)


def noise_pixels(n: int, size: int, device) -> torch.Tensor:
    """``n`` seeded ``N(0, 0.5²)`` images at ``size`` (the JAX package's
    calibration batch, drawn from a ``torch.Generator``)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn(n, size, size, 3, generator=gen, device=device) * 0.5


def calibration_pixels(config: NaFlexConfig, image_size: int,
                       device) -> list[torch.Tensor]:
    """What the encoder's fused tower calibrates on: 4 noise images at the
    tower's size, and 4 region canvases as ``RegionExtractor.prepare``
    lays them out (a noise crop at the top left, 1/3 to all of each side,
    the rest the normalised value of a zero pixel).

    The JAX package calibrates on the noise images alone, and its static
    activation scales then clip the attention outputs of zero-padded region
    canvases (ROADMAP C4)."""
    canvas = config.region_resolution
    gen = torch.Generator(device=device).manual_seed(1)
    pad = -torch.tensor(config.image_mean, device=device) / torch.tensor(
        config.image_std, device=device)
    regions = pad.expand(4, canvas, canvas, 3).clone()
    for i, (h, w) in enumerate(((canvas, canvas // 2), (canvas * 3 // 4, canvas),
                                (canvas, canvas), (canvas // 3, canvas))):
        regions[i, :h, :w] = torch.randn(h, w, 3, generator=gen, device=device) * 0.5
    return [noise_pixels(4, image_size, device), regions]


class FusedSigLIPBackend(_TowerBackend):
    """The fused W8A8 tower (:mod:`gvl_tpu_torch.models.siglip_fused`) on
    the int8 kernels.  Built from the tower's weights in bf16: quantize,
    calibrate the activation scales on ``calib_pixels`` (one batch or a
    list of batches, each at its own canvas size; the amax is the largest
    over all of them), fuse.  The JAX package calibrates on
    ``noise_pixels(4, image_size)``; the encoder on
    :func:`calibration_pixels`."""

    def __init__(self, tower, *, calib_pixels, image_mean=(0.5, 0.5, 0.5),
                 image_std=(0.5, 0.5, 0.5), pool_strategy: str = "mean",
                 packed_attention: bool = False):
        device = next(tower.parameters()).device
        super().__init__(image_mean, image_std, pool_strategy, device)
        self.tower = tower
        self.config = tower.config
        if torch.is_tensor(calib_pixels) or isinstance(calib_pixels, np.ndarray):
            calib_pixels = [calib_pixels]
        calib = [torch.as_tensor(p, device=device) for p in calib_pixels]
        state = {k: v.to(torch.bfloat16) for k, v in tower.state_dict().items()}
        self.fused = prepare_fused_siglip(state, self.config, calib,
                                          packed_attention=packed_attention)

    @torch.inference_mode()
    def __call__(self, batch: np.ndarray) -> tuple[None, np.ndarray]:
        out = siglip_fused_apply(self.fused, self.normalize(batch, torch.bfloat16),
                                 self.config, pool=self.pool_strategy == "cls")
        return None, self.pooled(out)


def build_vision_backend(tower, config: NaFlexConfig):
    """:class:`FusedSigLIPBackend` (calibrated on :func:`calibration_pixels`)
    or :class:`TorchSigLIPBackend` per ``config.quant_fused``."""
    kw = dict(image_mean=config.image_mean, image_std=config.image_std,
              pool_strategy=config.pool_strategy)
    if config.quant_fused:
        calib = calibration_pixels(config, tower.config.image_size,
                                   next(tower.parameters()).device)
        return FusedSigLIPBackend(tower, calib_pixels=calib, **kw)
    return TorchSigLIPBackend(tower, config.dtype, **kw)


class SigLIPSemanticEncoder:
    """Mask regions → semantic embeddings (the segmenter → SigLIP bridge).

    >>> encoder = SigLIPSemanticEncoder()   # fake backend, no weights
    >>> embs = encoder.encode_masked_regions(frame, [("e1", mask)])
    """

    def __init__(self, config: Optional[NaFlexConfig] = None,
                 backend: Optional[Callable] = None,
                 projection: Optional[Callable] = None):
        self.config = config or NaFlexConfig()
        self.region_extractor = RegionExtractor(self.config)
        self.backend = backend or DeterministicFakeBackend(self.config.embedding_dim)
        self.projection = projection

    @classmethod
    def from_hf_checkpoint(cls, path: str, config: Optional[NaFlexConfig] = None):
        raise NotImplementedError(
            "HF SigLIP checkpoints are not ported yet (ROADMAP A10)")

    @classmethod
    def from_trained_checkpoint(cls, path: str, config: Optional[NaFlexConfig] = None,
                                device: str | torch.device = "cuda"):
        """The self-trained mini-SigLIP directory (``outputs/minisiglip``):
        region embeddings in its learned image-text space, whose contrastive
        side is the MAP-pooled output, so pooling is forced to 'cls' and
        crops are encoded at the tower's own training canvas."""
        from gvl_tpu_torch.training.siglip_train import load_minisiglip

        model, vision_cfg, _ = load_minisiglip(path, device)
        config = config or NaFlexConfig()
        config.embedding_dim = vision_cfg.hidden_size
        config.pool_strategy = "cls"
        config.base_resolution = vision_cfg.image_size
        config.region_resolution = vision_cfg.image_size
        vcfg, state = _maybe_quantize_tower(vision_cfg, model.vision.state_dict(), config)
        tower = model.vision if vcfg is vision_cfg else load_tower(vcfg, state, device)
        return cls(config, backend=build_vision_backend(tower, config))

    @classmethod
    def with_random_tower(cls, config: Optional[NaFlexConfig] = None,
                          device: str | torch.device = "cuda", seed: int = 0,
                          vision_config: Optional[SigLIPVisionConfig] = None):
        """The so400m tower (or ``vision_config``) on random weights drawn
        from a ``torch.Generator`` seeded with ``seed``: the whole compute
        path without a checkpoint (embeddings are meaningless)."""
        config = config or NaFlexConfig()
        device = resolve_device(device)
        vcfg = vision_config or SigLIPVisionConfig.so400m()
        dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
        gen = torch.Generator(device=device).manual_seed(seed)
        state = init_tower_params(vcfg, gen, dtype=dtype, device=device)
        vcfg, state = _maybe_quantize_tower(vcfg, state, config)
        tower = load_tower(vcfg, state, device)
        return cls(config, backend=build_vision_backend(tower, config))

    # ------------------------------------------------------------ encoding

    def _pool(self, sequence, pooled: np.ndarray) -> np.ndarray:
        if sequence is None:   # the backend pooled on the card
            return pooled
        strategy = self.config.pool_strategy
        if strategy == "mean":
            return sequence.mean(axis=1)
        if strategy == "max":
            return sequence.max(axis=1)
        return pooled

    def _bucket_pad(self, n: int) -> int:
        for b in (1, 4, 8, self.config.batch_size):
            if n <= b:
                return b
        step = self.config.batch_size
        return ((n + step - 1) // step) * step

    def encode_image(self, image) -> np.ndarray:
        """One full image → ``(embedding_dim,)``."""
        prepared, _ = self.region_extractor.prepare(np.asarray(image))
        seq, pooled = self.backend(prepared[None])
        return self._pool(seq, pooled)[0]

    def prepare_regions(self, frame: np.ndarray, masks) -> tuple[list, list]:
        """(uint8 region canvases, per-region metadata) of one frame."""
        prepared, metadata = [], []
        for entity_id, mask in masks:
            region, bbox = self.region_extractor.extract_masked_region(frame, mask)
            tensor, aspect = self.region_extractor.prepare(
                region, self.config.region_resolution)
            prepared.append(tensor)
            metadata.append({"entity_id": entity_id, "bbox": bbox, "aspect_ratio": aspect})
        return prepared, metadata

    def encode_masked_regions(self, frame: np.ndarray,
                              masks: Sequence[tuple[str, np.ndarray]]) -> list[SemanticEmbedding]:
        """Every (entity_id, mask) region of one frame, in bucketed batches."""
        if not masks:
            return []
        return self._encode_prepared(*self.prepare_regions(frame, masks))

    def _batches(self, prepared: list[np.ndarray]):
        """(start, real count, pooled) per bucket-padded batch."""
        step = self.config.batch_size
        for i in range(0, len(prepared), step):
            chunk = prepared[i:i + step]
            n = len(chunk)
            batch = np.stack(chunk + [np.zeros_like(chunk[0])] * (self._bucket_pad(n) - n))
            seq, pooled = self.backend(batch)
            yield i, n, self._pool(seq, pooled)[:n]

    def _encode_prepared(self, prepared: list[np.ndarray],
                         metadata: list[dict]) -> list[SemanticEmbedding]:
        out: list[SemanticEmbedding] = []
        for i, n, embeddings in self._batches(prepared):
            if self.projection is not None:
                embeddings = np.asarray(self.projection(embeddings))
            for emb, meta in zip(embeddings, metadata[i:i + n]):
                out.append(SemanticEmbedding(
                    embedding=np.asarray(emb), entity_id=meta["entity_id"],
                    confidence=1.0, original_bbox=meta["bbox"],
                    aspect_ratio=meta["aspect_ratio"]))
        return out

    def encode_regions_multi(self, frame_masks) -> list[list[SemanticEmbedding]]:
        """Regions of many frames in shared bucketed batches; one list per
        frame, order kept."""
        prepared, metadata, owners = [], [], []
        for fi, (frame, masks) in enumerate(frame_masks):
            p, m = self.prepare_regions(np.asarray(frame), masks)
            prepared += p
            metadata += m
            owners += [fi] * len(p)
        flat = self._encode_prepared(prepared, metadata)
        out: list[list[SemanticEmbedding]] = [[] for _ in frame_masks]
        for emb, fi in zip(flat, owners):
            out[fi].append(emb)
        return out

    def encode_images_batch(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """Whole-frame embeddings for a batch of frames, bucket-padded."""
        if not len(images):
            return np.zeros((0, self.config.embedding_dim), np.float32)
        prepared = [self.region_extractor.prepare(np.asarray(img))[0] for img in images]
        return np.concatenate([emb for _, _, emb in self._batches(prepared)], axis=0)

    @staticmethod
    def compute_similarity(emb1: SemanticEmbedding, emb2: SemanticEmbedding) -> float:
        a = emb1.embedding.astype(np.float64)
        b = emb2.embedding.astype(np.float64)
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        return float(a @ b / denom) if denom else 0.0

    def find_similar_regions(self, query: SemanticEmbedding,
                             candidates: Sequence[SemanticEmbedding], top_k: int = 5):
        scored = [(c, self.compute_similarity(query, c)) for c in candidates]
        scored.sort(key=lambda t: t[1], reverse=True)
        return scored[:top_k]
