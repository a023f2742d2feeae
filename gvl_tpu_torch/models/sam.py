"""Open-vocabulary promptable segmenter ("SAM3-class"), counterpart of
:mod:`gvl_tpu.models.sam`.

- ViT image encoder → per-patch features (``neck`` to the decoder width);
- hashed-word text tower → one prompt embedding per concept;
- query mask decoder: ``num_queries`` learned queries plus the prompt
  cross-attend the image features (and the prompt), self-attend, and each
  emits a mask (dot product with a pixel embedding map at 1/4 resolution)
  and a score.

Every attention goes through the flash kernel: the image encoder and the
text tower at head size 64, the decoder's 8 heads over 256 at head size
32, which the kernel's wrapper pads to 64.  One call segments every
(frame, concept) pair; the image features and the pixel map are computed
once per frame.  Weights are f32, as the JAX model's.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from gvl_tpu_torch.nn.layers import (
    Attention,
    LayerNorm,
    MlpGelu,
    TransformerBlock,
    TransformerStack,
)


@dataclass(frozen=True)
class SamConfig:
    """Model geometry (defaults: gameplay frames at 256 px, the geometry of
    ``outputs/sam_params.npz``)."""

    image_size: int = 256
    patch_size: int = 16
    encoder_dim: int = 384
    encoder_layers: int = 6
    encoder_heads: int = 6
    text_vocab: int = 4096       # hashed-wordpiece vocabulary
    text_dim: int = 256
    text_layers: int = 2
    decoder_dim: int = 256
    decoder_layers: int = 2
    num_queries: int = 8         # max instances per (frame, concept)
    mask_downscale: int = 4      # masks decoded at image_size / this

    @property
    def tokens_per_side(self) -> int:
        return self.image_size // self.patch_size

    @classmethod
    def tiny(cls) -> "SamConfig":
        return cls(image_size=64, patch_size=16, encoder_dim=64,
                   encoder_layers=2, encoder_heads=2, text_dim=32,
                   text_layers=1, decoder_dim=64, decoder_layers=1,
                   num_queries=4)


TEXT_TOKENS = 16    # hash_tokenize's length, the size of the text positions
TEXT_HEADS = 4      # the text tower's heads (fixed in the JAX model)
DECODER_HEADS = 8   # the mask decoder's heads (fixed in the JAX model)


def hash_tokenize(text: str, vocab: int, max_len: int = TEXT_TOKENS) -> np.ndarray:
    """Deterministic word-hash tokenizer (no vocabulary files)."""
    words = text.lower().split()[:max_len]
    ids = [zlib.crc32(w.encode()) % (vocab - 1) + 1 for w in words]
    ids += [0] * (max_len - len(ids))
    return np.asarray(ids, np.int32)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[in_size, out_size]`` f32 weights of ``jax.image.resize``'s
    "bilinear" along one axis: a triangle kernel at half-pixel sample
    points, widened by in/out when shrinking (antialiasing), each column
    normalised, zero where the sample falls outside the input."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_bilinear(grid: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``[H, W, D]`` → ``[height, width, D]`` as ``jax.image.resize(grid,
    (height, width, D), "bilinear")`` computes it (f32; an axis of equal
    size is left as it is)."""
    h, w, _ = grid.shape
    out = grid.float()
    if h != height:
        wy = torch.from_numpy(resize_weights(h, height)).to(grid.device)
        out = torch.einsum("hwd,hH->Hwd", out, wy)
    if w != width:
        wx = torch.from_numpy(resize_weights(w, width)).to(grid.device)
        out = torch.einsum("hwd,wW->hWd", out, wx)
    return out


class TextTower(nn.Module):
    """Hashed tokens ``[C, T]`` → one prompt embedding ``[C, decoder_dim]``:
    embeddings plus positions, LayerNorm/GELU blocks, a mean over the
    non-pad tokens, a projection."""

    def __init__(self, config: SamConfig):
        super().__init__()
        d = config.text_dim
        self.embed = nn.Embedding(config.text_vocab, d)
        self.pos = nn.Parameter(torch.zeros(TEXT_TOKENS, d))
        self.layers = nn.ModuleList(TransformerBlock(d, TEXT_HEADS, d * 4)
                                    for _ in range(config.text_layers))
        self.proj = nn.Linear(d, config.decoder_dim)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        x = self.embed(token_ids.long()) + self.pos[None, : token_ids.shape[-1]]
        for layer in self.layers:
            x = layer(x)
        mask = (token_ids > 0)[..., None].to(x.dtype)
        pooled = (x * mask).sum(1) / mask.sum(1).clamp(min=1)
        return self.proj(pooled)


class ImageEncoder(nn.Module):
    """ViT over ``[B, H, W, 3]`` → ``[B, (H/p)(W/p), decoder_dim]``; the
    learned position grid is resized (:func:`resize_bilinear`) when the
    frame is not ``image_size``."""

    def __init__(self, config: SamConfig):
        super().__init__()
        self.config = config
        d, p = config.encoder_dim, config.patch_size
        self.patch_proj = nn.Linear(p * p * 3, d)
        self.pos = nn.Parameter(torch.zeros(config.tokens_per_side ** 2, d))
        self.encoder = TransformerStack(config.encoder_layers, d, config.encoder_heads, d * 4)
        self.neck = nn.Linear(d, config.decoder_dim)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        from gvl_tpu_torch.models.siglip import patchify

        p = self.config.patch_size
        nh, nw = pixels.shape[1] // p, pixels.shape[2] // p
        x = self.patch_proj(patchify(pixels, p))
        pos = self.pos
        if pos.shape[0] != x.shape[1]:
            side = self.config.tokens_per_side
            pos = resize_bilinear(pos.reshape(side, side, -1), nh, nw).reshape(nh * nw, -1)
        x = x + pos[None].to(x.dtype)
        return self.neck(self.encoder(x))


class MaskDecoder(nn.Module):
    """Prompt-conditioned queries → per-query masks and scores.

    ``image_feats [F, HW, d]`` and ``prompts [F, C, d]`` (C prompts per
    frame; the JAX module's batch of pairs is F pairs with C = 1) →
    ``mask_logits [F, C, Q, side·up, side·up]``, ``scores [F, C, Q]``.
    Flax names: ``cross_{i}``, ``self_{i}``, ``mlp_{i}`` and their
    ``*_norm_{i}``."""

    def __init__(self, config: SamConfig):
        super().__init__()
        self.config = config
        d = config.decoder_dim
        self.up = config.patch_size // config.mask_downscale
        self.queries = nn.Parameter(torch.zeros(config.num_queries, d))
        for i in range(config.decoder_layers):
            self.add_module(f"cross_norm_{i}", LayerNorm(d))
            self.add_module(f"cross_{i}", Attention(d, DECODER_HEADS))
            self.add_module(f"self_norm_{i}", LayerNorm(d))
            self.add_module(f"self_{i}", Attention(d, DECODER_HEADS))
            self.add_module(f"mlp_norm_{i}", LayerNorm(d))
            self.add_module(f"mlp_{i}", MlpGelu(d, d * 4))
        self.pixel_head = nn.Linear(d, d * self.up * self.up)
        self.mask_head = nn.Linear(d, d)
        self.score_head = nn.Linear(d, 1)

    def forward(self, image_feats: torch.Tensor,
                prompts: torch.Tensor) -> dict[str, torch.Tensor]:
        f, hw, d = image_feats.shape
        c, nq = prompts.shape[1], self.config.num_queries
        q = (self.queries[None, None].to(image_feats.dtype)
             + prompts[:, :, None, :].to(image_feats.dtype)).reshape(f * c, nq, d)
        kv = torch.cat([image_feats[:, None].expand(f, c, hw, d),
                        prompts[:, :, None, :].to(image_feats.dtype)], dim=2)
        kv = kv.reshape(f * c, hw + 1, d)
        for i in range(self.config.decoder_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")
            q = q + layer("cross")(layer("cross_norm")(q), kv)
            q = q + layer("self")(layer("self_norm")(q))
            q = q + layer("mlp")(layer("mlp_norm")(q))
        side, up = int(round(float(np.sqrt(hw)))), self.up
        pix = self.pixel_head(image_feats).reshape(f, side, side, up, up, d)
        pix = pix.permute(0, 1, 3, 2, 4, 5).reshape(f, side * up, side * up, d)
        mask_emb = self.mask_head(q).reshape(f, c, nq, d)
        logits = torch.einsum("fcqd,fhwd->fcqhw", mask_emb, pix)
        scores = torch.sigmoid(self.score_head(q)[..., 0]).reshape(f, c, nq)
        return {"mask_logits": logits, "scores": scores}


class PromptableSegmenter(nn.Module):
    """pixels ``[F, H, W, 3]`` (floats in [0, 1]) and token ids ``[C, T]`` →
    ``mask_logits [F, C, Q, H/ds, W/ds]`` and ``scores [F, C, Q]``."""

    def __init__(self, config: SamConfig):
        super().__init__()
        self.config = config
        self.image_encoder = ImageEncoder(config)
        self.text_tower = TextTower(config)
        self.decoder = MaskDecoder(config)

    def forward(self, pixels: torch.Tensor, token_ids: torch.Tensor) -> dict[str, torch.Tensor]:
        feats = self.image_encoder(pixels)
        prompts = self.text_tower(token_ids)
        out = self.decoder(feats, prompts[None].expand(feats.shape[0], -1, -1))
        f, c, q = out["scores"].shape
        side = pixels.shape[1] // self.config.mask_downscale
        return {"mask_logits": out["mask_logits"].reshape(f, c, q, side, -1),
                "scores": out["scores"]}

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """The image encoder's features ``[F, tokens, encoder_dim]``."""
        return self.image_encoder(pixels)


def load_segmenter_npz(path) -> dict:
    """The JAX package's flat-npz variables (``{"params": ...}``), numpy."""
    from gvl_tpu_torch.utils.checkpoints import load_flat_npz

    return load_flat_npz(path)


def save_segmenter_npz(state: dict, path, config: SamConfig = None) -> None:
    """The JAX package's flat-npz variables (``params/...``) of a segmenter's
    state dict (``config``: its geometry, ``SamConfig()`` by default)."""
    from gvl_tpu_torch.models.convert import sam_params_from_jax, tree_from_state
    from gvl_tpu_torch.training.init_laws import sam_layout, shapes
    from gvl_tpu_torch.utils.checkpoints import save_flat_npz

    config = config or SamConfig()
    layout = shapes(sam_layout(config, state["text_tower.pos"].shape[0]))
    save_flat_npz(tree_from_state(lambda t: sam_params_from_jax(t, config), layout, state),
                  path)
