"""The self-trained mini-SigLIP, inference only (counterpart of the inference
half of :mod:`gvl_tpu.training.siglip_train`).

Both towers of ``outputs/minisiglip`` (vision 384 wide x 6 layers x 6 heads
at 128 px, text 384 x 4 layers over 32 byte positions) under one
:class:`MiniSigLIP` module: unit image and text embeddings in the
contrastive space the trainer aligned, whose image side is the MAP-pooled
output.  Their attention goes through the flash kernel (head 64).  The
caption pools, the byte tokenizer, the zero-shot crop evaluation
(:func:`evaluate_minisiglip`) and the open-vocabulary segmentation metrics
(:func:`evaluate_open_vocab`) are the JAX module's; training stays in the
JAX package.

The JAX package hands the towers bf16 pixels with f32 parameters, so Flax
promotes and the towers compute in f32: :meth:`MiniSigLIP.encode_image`
takes pixels of any type and computes in the parameters' type.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.siglip import (
    SigLIPTextConfig,
    SigLIPTextTower,
    SigLIPVisionConfig,
    SigLIPVisionTower,
)
from gvl_tpu_torch.training.retriever_train import byte_tokenize  # noqa: F401 (the JAX module's name)
from gvl_tpu_torch.training.segmenter_train import CONCEPTS, make_scene

# caption pools per class: the first entry is the canonical zero-shot
# prompt; the rest are training-time synonyms/templates
CAPTIONS: dict[str, tuple[str, ...]] = {
    "player": ("player", "the player", "player character", "the hero",
               "main character", "a blue square player",
               "sprite of the player"),
    "enemy": ("enemy", "an enemy", "a hostile enemy", "a monster",
              "a red enemy", "enemy unit", "sprite of an enemy"),
    "boss": ("boss", "the boss", "a boss enemy", "a large boss",
             "the purple boss", "boss monster"),
    "item": ("item", "an item", "a collectible item", "a pickup",
             "loot", "a yellow item", "sprite of an item"),
    # negative classes: crops that must NOT score as any entity
    "background": ("background", "empty background", "terrain",
                   "the level background", "scenery", "ground tiles"),
    "ui": ("ui element", "status bar", "hud element", "health bar",
           "on-screen text", "interface overlay"),
}
CLASSES = tuple(CAPTIONS)
ENTITY_CLASSES = CONCEPTS  # the 4 promptable concepts

# prompts NEVER sampled in training (not in any CAPTIONS pool): the
# zero-shot generalization probe for open-vocab naming
UNSEEN_PROMPTS: dict[str, str] = {
    "player": "the protagonist",
    "enemy": "a villain",
    "boss": "a giant foe",
    "item": "a power-up",
}


def minisiglip_vision_config(**kw) -> SigLIPVisionConfig:
    base = dict(hidden_size=384, intermediate_size=1536, num_layers=6,
                num_heads=6, patch_size=16, image_size=128)
    base.update(kw)
    return SigLIPVisionConfig(**base)


def minisiglip_text_config(**kw) -> SigLIPTextConfig:
    base = dict(hidden_size=384, intermediate_size=1536, num_layers=4,
                num_heads=6, vocab_size=256, max_position=32,
                projection_size=384)
    base.update(kw)
    return SigLIPTextConfig(**base)


def _unit(z: torch.Tensor) -> torch.Tensor:
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-9)


class MiniSigLIP(nn.Module):
    """Both towers and the sigmoid loss's temperature and bias."""

    def __init__(self, vision_config: SigLIPVisionConfig, text_config: SigLIPTextConfig):
        super().__init__()
        self.vision_config, self.text_config = vision_config, text_config
        self.vision = SigLIPVisionTower(vision_config)
        self.text = SigLIPTextTower(text_config)
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(10.0))))
        self.logit_bias = nn.Parameter(torch.tensor(-10.0))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """Normalised ``[B, H, W, 3]`` pixels → unit MAP-pooled embeddings,
        computed in the promoted type of the pixels and the weights."""
        dtype = torch.promote_types(pixels.dtype, self.logit_scale.dtype)
        return _unit(self.vision(pixels.to(dtype), pool=True)["pooled"])

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        return _unit(self.text(ids)["pooled"])

    def forward(self, pixels: torch.Tensor, ids: torch.Tensor):
        zi, zt = self.encode_image(pixels), self.encode_text(ids)
        return zi, zt, zi @ zt.T * self.logit_scale.exp() + self.logit_bias


def load_minisiglip(ckpt_dir, device: str | torch.device = "cuda"
                    ) -> tuple[MiniSigLIP, SigLIPVisionConfig, SigLIPTextConfig]:
    """(model in eval mode on ``device``, vision config, text config) of a
    trained mini-SigLIP directory (``minisiglip_config.json`` and the
    flat-npz ``params.npz``)."""
    from gvl_tpu_torch.models.convert import minisiglip_params_from_jax
    from gvl_tpu_torch.nn.layers import load_module
    from gvl_tpu_torch.utils.checkpoints import load_flat_npz

    device = resolve_device(device)
    ckpt = Path(ckpt_dir)
    raw = json.loads((ckpt / "minisiglip_config.json").read_text())
    vision_cfg = SigLIPVisionConfig(**raw["vision"])
    text_cfg = SigLIPTextConfig(**raw["text"])
    state = minisiglip_params_from_jax(load_flat_npz(ckpt / "params.npz"),
                                       vision_cfg, text_cfg)
    with torch.device("meta"):
        model = MiniSigLIP(vision_cfg, text_cfg)
    return load_module(model, state, device), vision_cfg, text_cfg


def is_minisiglip_checkpoint(path) -> bool:
    return bool(path) and (Path(path) / "minisiglip_config.json").exists()


# --------------------------------------------------------------------------
# Crop/caption pairs from synthetic scenes (what the evaluation draws)
# --------------------------------------------------------------------------

def _to_canvas(image: np.ndarray, canvas: int) -> np.ndarray:
    from gvl_tpu_torch.perception.semantic import AspectPreservingResizer, NaFlexConfig

    out, _ = AspectPreservingResizer(NaFlexConfig()).resize_to_canvas(image, canvas)
    return out


def _crop_instance(frame: np.ndarray, mask: np.ndarray,
                   rng: np.random.Generator, canvas: int) -> np.ndarray:
    """Inference-matching region crop: bbox (jittered 5-20% expansion)
    resized aspect-preserved onto the canvas."""
    ys, xs = np.where(mask)
    x1, x2 = int(xs.min()), int(xs.max())
    y1, y2 = int(ys.min()), int(ys.max())
    h, w = frame.shape[:2]
    ex = (x2 - x1 + 1) * rng.uniform(0.05, 0.2)
    ey = (y2 - y1 + 1) * rng.uniform(0.05, 0.2)
    x1 = max(0, int(x1 - ex)); x2 = min(w - 1, int(x2 + ex))
    y1 = max(0, int(y1 - ey)); y2 = min(h - 1, int(y2 + ey))
    return _to_canvas(frame[y1:y2 + 1, x1:x2 + 1], canvas)


def _background_crop(frame: np.ndarray, gt_masks: np.ndarray,
                     rng: np.random.Generator, canvas: int) -> Optional[np.ndarray]:
    """A crop that overlaps no entity mask (the 'background' class)."""
    size = frame.shape[0]
    occupied = gt_masks.any((0, 1))
    for _ in range(8):
        s = int(rng.integers(size // 8, size // 3))
        x = int(rng.integers(0, size - s))
        y = int(rng.integers(0, size - s))
        if not occupied[y:y + s, x:x + s].any():
            return _to_canvas(frame[y:y + s, x:x + s], canvas)
    return None


def _ui_crop(rng: np.random.Generator, canvas: int) -> np.ndarray:
    """A standalone HUD-furniture crop (status bar / glyph row) on a dark
    field: the 'ui' negative class."""
    h, w = int(rng.integers(24, 48)), int(rng.integers(64, 128))
    tile = np.full((h, w, 3), rng.integers(15, 50, 3), np.uint8)
    if rng.random() < 0.5:      # status bar
        bh = int(rng.integers(5, max(6, h // 3)))
        by = int(rng.integers(0, h - bh))
        fill = int(rng.integers(w // 4, w))
        col = rng.integers(100, 256, 3).astype(np.uint8)
        tile[by:by + bh, :fill] = col
        tile[by:by + bh, fill:] = (60, 60, 60)
    else:                       # glyph row
        gh = int(rng.integers(6, max(7, h // 2)))
        gy = int(rng.integers(0, h - gh))
        bright = rng.integers(170, 256, 3).astype(np.uint8)
        x = int(rng.integers(0, 8))
        while x < w - 4:
            gw = int(rng.integers(2, 5))
            tile[gy:gy + gh, x:x + gw] = bright
            x += gw + int(rng.integers(1, 4))
    return _to_canvas(tile, canvas)


def make_pairs(rng: np.random.Generator, n: int, canvas: int,
               styles: tuple[str, ...] = ("base", "aug"), scene_size: int = 256,
               canonical_captions: bool = False
               ) -> tuple[np.ndarray, list[str], np.ndarray]:
    """n (crop, caption, class_id) pairs: ~72% entity crops, ~18%
    background, ~10% UI furniture; captions from the class pool, or the
    canonical prompt for evaluation (the JAX trainer's compositional
    captions are not ported)."""
    images = np.zeros((n, canvas, canvas, 3), np.uint8)
    captions: list[str] = []
    class_ids = np.zeros(n, np.int32)

    def caption(concept: str) -> str:
        return (CAPTIONS[concept][0] if canonical_captions
                else str(rng.choice(CAPTIONS[concept])))

    i = 0
    while i < n:
        style = styles[int(rng.integers(0, len(styles)))]
        frame, gt_masks, gt_valid = make_scene(rng, scene_size, 2, style=style)
        for ci, concept in enumerate(CONCEPTS):
            for k in range(gt_valid.shape[1]):
                if i >= n or not gt_valid[ci, k]:
                    continue
                if not gt_masks[ci, k].any():
                    continue
                images[i] = _crop_instance(frame, gt_masks[ci, k], rng, canvas)
                captions.append(caption(concept))
                class_ids[i] = CLASSES.index(concept)
                i += 1
        if i < n and rng.random() < 0.65:
            bg = _background_crop(frame, gt_masks, rng, canvas)
            if bg is not None:
                images[i] = bg
                captions.append(caption("background"))
                class_ids[i] = CLASSES.index("background")
                i += 1
        if i < n and rng.random() < 0.35:
            images[i] = _ui_crop(rng, canvas)
            captions.append(caption("ui"))
            class_ids[i] = CLASSES.index("ui")
            i += 1
    return images, captions, class_ids


# --------------------------------------------------------------------------
# Evaluation: zero-shot crop classification, open-vocab segmentation
# --------------------------------------------------------------------------

@torch.inference_mode()
def evaluate_minisiglip(model: MiniSigLIP, n_crops: int = 128, style: str = "base",
                        seed: int = 1234, canvas: int = 128) -> dict:
    """Zero-shot accuracy of held-out crops against the canonical prompt
    per class, and the mean positive-vs-best-other cosine margin."""
    from gvl_tpu_torch.ops.quant_matmul import true_div

    device = model.logit_scale.device
    rng = np.random.default_rng(seed)
    images, _, class_ids = make_pairs(rng, n_crops, canvas, styles=(style,),
                                      canonical_captions=True)
    prompts = [CAPTIONS[c][0] for c in CLASSES]
    ids = torch.from_numpy(byte_tokenize(prompts, model.text_config.max_position)).to(device)
    px = true_div(torch.from_numpy(images).to(device).float(), 255.0) * 2.0 - 1.0
    sims = (model.encode_image(px) @ model.encode_text(ids).T).float().cpu().numpy()
    pred = sims.argmax(-1)
    correct = pred == class_ids
    ent = np.isin(class_ids, [CLASSES.index(c) for c in ENTITY_CLASSES])
    pos = sims[np.arange(len(sims)), class_ids]
    other = sims.copy()
    other[np.arange(len(sims)), class_ids] = -np.inf
    return {
        "zero_shot_acc": float(correct.mean()),
        "entity_acc": float(correct[ent].mean()) if ent.any() else 0.0,
        "negative_acc": float(correct[~ent].mean()) if (~ent).any() else 0.0,
        "margin": float((pos - other.max(-1)).mean()),
        "n": n_crops,
        "style": style,
    }


def evaluate_open_vocab(backend, n_scenes: int = 16, style: str = "base",
                        prompts: Optional[dict] = None, scene_size: int = 256,
                        seed: int = 4321, iou_match: float = 0.5) -> dict:
    """Grounded open-vocab segmentation metrics over synthetic scenes.

    ``backend`` follows the segmenter backend protocol (``(frames,
    concepts, frame_indices) → results[frame][concept]``, e.g.
    :class:`~gvl_tpu_torch.perception.open_vocab.OpenVocabSamBackend`),
    prompted with ``prompts[concept]`` and scored per ground-truth
    instance: ``det_correct`` (a detection under the right prompt at IoU
    ≥ ``iou_match``) and ``label_acc`` (among instances localized by any
    prompt, the share localized by the right one)."""
    prompts = prompts or {c: c for c in CONCEPTS}
    rng = np.random.default_rng(seed)
    concept_texts: Sequence[str] = [prompts[c] for c in CONCEPTS]
    total = det_correct = localized = label_correct = 0
    for _ in range(n_scenes):
        frame, gt_masks, gt_valid = make_scene(rng, scene_size, 2, style=style)
        results = backend([frame], concept_texts, [0])[0]
        for ci in range(len(CONCEPTS)):
            for k in range(gt_valid.shape[1]):
                if not gt_valid[ci, k] or not gt_masks[ci, k].any():
                    continue
                total += 1
                gt = gt_masks[ci, k]
                best_iou = []
                for pj in range(len(CONCEPTS)):
                    best = 0.0
                    for det in results[pj]:
                        m = det["mask"].mask
                        inter = (m & gt).sum()
                        union = (m | gt).sum()
                        if union:
                            best = max(best, inter / union)
                    best_iou.append(best)
                if best_iou[ci] >= iou_match:
                    det_correct += 1
                if max(best_iou) >= iou_match:
                    localized += 1
                    if best_iou[ci] >= iou_match:
                        label_correct += 1
    return {
        "det_correct": det_correct / max(total, 1),
        "label_acc": label_correct / max(localized, 1),
        "localized": localized / max(total, 1),
        "n_instances": total,
        "style": style,
    }
