"""The self-trained mini-SigLIP and its trainer (counterpart of
:mod:`gvl_tpu.training.siglip_train`).

Both towers of ``outputs/minisiglip`` (vision 384 wide x 6 layers x 6 heads
at 128 px, text 384 x 4 layers over 32 byte positions) under one
:class:`MiniSigLIP` module: unit image and text embeddings in the
contrastive space the trainer aligned, whose image side is the MAP-pooled
output.  Their attention goes through the flash kernel (head 64).  The
caption pools, the byte tokenizer, the zero-shot crop evaluation
(:func:`evaluate_minisiglip`) and the open-vocabulary segmentation metrics
(:func:`evaluate_open_vocab`) are the JAX module's.  :func:`train_minisiglip`
trains both towers with the SigLIP sigmoid loss over multi-positive labels
(same-class pairs in a batch are positives) on a pool of crop/caption
batches indexed ``step % pool``, optionally after
:func:`pretrain_text_tower` (word↔context contrastive pretraining of the
text tower on :mod:`~gvl_tpu_torch.training.text_corpus`, which optimises
the tower and its own temperature and bias together); AdamW over a warmup
cosine schedule, every parameter decayed as Optax does.

The JAX package hands the towers bf16 pixels with f32 parameters, so Flax
promotes and the towers compute in f32: :meth:`MiniSigLIP.encode_image`
takes pixels of any type and computes in the parameters' type.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
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

logger = logging.getLogger(__name__)

# compositional caption space: head-noun synonyms x surface templates x
# occasional class adjectives; the UNSEEN_PROMPTS probe words are excluded
HEAD_NOUNS: dict[str, tuple[str, ...]] = {
    "player": ("player", "hero", "main character", "player character",
               "avatar", "adventurer", "character you control"),
    "enemy": ("enemy", "monster", "opponent", "adversary", "attacker",
              "hostile creature", "baddie", "enemy unit"),
    "boss": ("boss", "boss enemy", "boss monster", "huge monster",
             "big bad", "elite enemy", "end-of-level enemy"),
    "item": ("item", "pickup", "collectible", "loot", "treasure",
             "bonus", "reward", "thing you can collect"),
    "background": ("background", "terrain", "scenery", "ground tiles",
                   "empty area", "level background", "floor"),
    "ui": ("ui element", "status bar", "hud element", "health bar",
           "interface overlay", "on-screen text", "menu bar"),
}
ADJECTIVES: dict[str, tuple[str, ...]] = {
    "player": ("blue", "small", "square"),
    "enemy": ("red", "hostile", "dangerous"),
    "boss": ("purple", "large", "big"),
    "item": ("yellow", "shiny", "small"),
    "background": (), "ui": (),
}
TEMPLATES: tuple[str, ...] = (
    "{}", "a {}", "the {}", "sprite of {}", "a {} sprite",
    "{} in the game", "{} on screen", "pixel art of {}",
    "a {} in a video game", "one {}",
)


def compose_caption(concept: str, rng: np.random.Generator, max_bytes: int = 32) -> str:
    """One caption from the compositional space, ≤ ``max_bytes`` UTF-8."""
    for _ in range(8):
        noun = str(rng.choice(HEAD_NOUNS[concept]))
        adjs = ADJECTIVES[concept]
        if adjs and rng.random() < 0.25:
            noun = f"{rng.choice(adjs)} {noun}"
        cap = str(rng.choice(TEMPLATES)).format(noun)
        if cap.startswith("a ") and noun[0] in "aeiou":
            cap = "an " + cap[2:]
        if len(cap.encode("utf-8")) <= max_bytes:
            return cap
    return str(rng.choice(CAPTIONS[concept]))

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


# --------------------------------------------------------------------------
# Loss and training
# --------------------------------------------------------------------------

def sigmoid_contrastive_loss(logits: torch.Tensor, class_ids: torch.Tensor) -> torch.Tensor:
    """SigLIP pairwise sigmoid loss with multi-positive labels: a pair (i, j)
    is positive iff the crops share a class."""
    same = class_ids[:, None] == class_ids[None, :]
    z = -torch.where(same, 1.0, -1.0) * logits
    # softplus(z) = -log sigmoid(-z), as jax.nn.softplus (logaddexp(z, 0))
    return torch.logaddexp(z, torch.zeros_like(z)).mean()


@dataclass
class SigLIPTrainConfig:
    steps: int = 4000
    batch_size: int = 64
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    warmup: int = 200
    seed: int = 0
    canvas: int = 128          # == NaFlexConfig.region_resolution
    styles: tuple[str, ...] = ("base", "aug")
    composed_frac: float = 0.0  # fraction of compositional captions
    pool_batches: int = 160    # distinct batches of the pool
    log_every: int = 200
    # corpus-backed text space: pretrain the text tower on the procedural
    # gameplay corpus before VL alignment, and keep the corpus objective as
    # an auxiliary loss
    text_pretrain_steps: int = 0
    text_corpus_weight: float = 0.0
    text_corpus_batch: int = 64
    vision: SigLIPVisionConfig = field(default_factory=minisiglip_vision_config)
    text: SigLIPTextConfig = field(default_factory=minisiglip_text_config)


def _text_from_jax(text_cfg: SigLIPTextConfig):
    from gvl_tpu_torch.models.convert import siglip_text_params_from_jax

    return lambda tree: siglip_text_params_from_jax(tree, text_cfg.num_layers)


def _minisiglip_from_jax(vision_cfg: SigLIPVisionConfig, text_cfg: SigLIPTextConfig):
    from gvl_tpu_torch.models.convert import minisiglip_params_from_jax

    return lambda tree: minisiglip_params_from_jax(tree, vision_cfg, text_cfg)


def text_tower_state(params: Optional[dict], text_cfg: SigLIPTextConfig, seed: int) -> dict:
    """The text tower's weights pretraining starts from: ``params`` (a state
    dict or the JAX tree) or, without it, drawn from ``seed`` by Flax's
    laws."""
    from gvl_tpu_torch.training import init_laws

    if params is not None:
        return init_laws.as_state(params, _text_from_jax(text_cfg))
    return init_laws.init_params(_text_from_jax(text_cfg),
                                 init_laws.siglip_text_layout(text_cfg), seed)


def minisiglip_state(params: Optional[dict], cfg: SigLIPTrainConfig) -> dict:
    """Both towers' weights a run starts from: ``params`` (a state dict or
    the JAX variables) or, without it, drawn from ``cfg.seed`` by Flax's
    laws (``logit_scale`` log 10, ``logit_bias`` -10)."""
    from gvl_tpu_torch.training import init_laws

    convert = _minisiglip_from_jax(cfg.vision, cfg.text)
    if params is not None:
        return init_laws.as_state(params, convert)
    return init_laws.init_params(convert, init_laws.minisiglip_layout(cfg.vision, cfg.text),
                                 cfg.seed)


def corpus_loss(encode, logit_scale: torch.Tensor, logit_bias: torch.Tensor,
                word_ids: torch.Tensor, ctx_ids: torch.Tensor,
                keys: torch.Tensor) -> torch.Tensor:
    """The word↔context sigmoid loss of one corpus batch (``encode``: ids →
    unit embeddings)."""
    logits = encode(word_ids) @ encode(ctx_ids).T * logit_scale.exp() + logit_bias
    return sigmoid_contrastive_loss(logits, keys)


class _TextPretrainer(nn.Module):
    """The text tower and the pretraining's own temperature and bias (the
    JAX trainer's ``(params, aux)``)."""

    def __init__(self, text_cfg: SigLIPTextConfig):
        super().__init__()
        self.text = SigLIPTextTower(text_cfg)
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(10.0))))
        self.logit_bias = nn.Parameter(torch.tensor(-10.0))

    def encode(self, ids: torch.Tensor) -> torch.Tensor:
        return _unit(self.text(ids)["pooled"])


def pretrain_text_tower(cfg: SigLIPTrainConfig, init_params: Optional[dict] = None,
                        device="cuda", on_step=None) -> dict[str, torch.Tensor]:
    """Word↔context contrastive pretraining of the byte text tower on the
    procedural gameplay corpus; returns the tower's state dict (JAX's
    ``pretrain_text_tower``: its own generator seeded ``seed + 7``, a pool
    of up to 120 corpus batches, AdamW over a warmup cosine schedule on the
    tower and its temperature and bias)."""
    from gvl_tpu_torch.training import init_laws, optim
    from gvl_tpu_torch.training.text_corpus import word_context_batch

    dev = resolve_device(device)
    mp = cfg.text.max_position
    rng = np.random.default_rng(cfg.seed + 7)
    state = {f"text.{k}": v for k, v in
             text_tower_state(init_params, cfg.text, cfg.seed + 7).items()}
    state.update(logit_scale=torch.tensor(np.float32(np.log(10.0))),
                 logit_bias=torch.tensor(np.float32(-10.0)))
    with torch.device("meta"):
        model = _TextPretrainer(cfg.text)
    model = init_laws.trainable(model, state, dev)
    steps = cfg.text_pretrain_steps
    opt = optim.AdamW(model.parameters(), optim.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, min(cfg.warmup, max(steps // 10, 1)), steps),
        clip=None, weight_decay=cfg.weight_decay)
    n_unique = min(steps, 120)
    pool = [tuple(torch.from_numpy(a).to(dev) for a in word_context_batch(
        rng, cfg.text_corpus_batch, mp)) for _ in range(n_unique)]
    for i in range(steps):
        w, c, k = pool[i % n_unique]
        loss = optim.train_step(model, opt, lambda m: corpus_loss(
            m.encode, m.logit_scale, m.logit_bias, w, c, k))
        if on_step is not None:
            on_step(i, loss)
        if cfg.log_every and (i % cfg.log_every == 0 or i == steps - 1):
            logger.info("text-pretrain step %d loss %.4f", i, float(loss))
    return {k[len("text."):]: v for k, v in init_laws.state_of(model).items()
            if k.startswith("text.")}


def minisiglip_loss(model: MiniSigLIP, pixels_u8: torch.Tensor, ids: torch.Tensor,
                    class_ids: torch.Tensor, corpus=None, corpus_weight: float = 0.0
                    ) -> torch.Tensor:
    """The VL sigmoid loss of one batch (uint8 crops mapped to [-1, 1]),
    plus ``corpus_weight`` x the corpus loss of ``corpus`` (word ids,
    context ids, keys) if given."""
    from gvl_tpu_torch.ops.quant_matmul import true_div

    pixels = true_div(pixels_u8.float(), 255.0) * 2.0 - 1.0
    _, _, logits = model(pixels, ids)
    loss = sigmoid_contrastive_loss(logits, class_ids)
    if corpus is not None:
        loss = loss + corpus_weight * corpus_loss(model.encode_text, model.logit_scale,
                                                  model.logit_bias, *corpus)
    return loss


def train_minisiglip(cfg: Optional[SigLIPTrainConfig] = None,
                     init_params: Optional[dict] = None,
                     text_init_params: Optional[dict] = None, device="cuda",
                     on_step=None) -> dict[str, torch.Tensor]:
    """Train :class:`MiniSigLIP` and return its f32 state dict (JAX's
    ``train_minisiglip``).  ``init_params`` warm-starts both towers and
    ``text_init_params`` the text pretraining (``text_pretrain_steps`` >
    0), whose tower replaces the drawn one; ``on_step(i, loss)`` sees each
    VL step's loss on the device.  Below 2 steps the schedule is
    constant."""
    from gvl_tpu_torch.training import init_laws, optim
    from gvl_tpu_torch.training.text_corpus import word_context_batch

    cfg = cfg or SigLIPTrainConfig()
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    mp = cfg.text.max_position
    state = dict(minisiglip_state(init_params, cfg))
    if cfg.text_pretrain_steps:
        pretrained = pretrain_text_tower(cfg, text_init_params, dev)
        state.update({f"text.{k}": v for k, v in pretrained.items()})
    with torch.device("meta"):
        model = MiniSigLIP(cfg.vision, cfg.text)
    model = init_laws.trainable(model, state, dev)
    logger.info("minisiglip params: %.2fM", sum(p.numel() for p in model.parameters()) / 1e6)
    warmup = min(cfg.warmup, max(cfg.steps // 10, 1), cfg.steps - 1)
    schedule = (cfg.learning_rate if cfg.steps < 2 else
                optim.warmup_cosine_decay_schedule(0.0, cfg.learning_rate, warmup, cfg.steps))
    opt = optim.AdamW(model.parameters(), schedule, clip=None, weight_decay=cfg.weight_decay)
    corpus_w = cfg.text_corpus_weight
    n_unique = min(cfg.steps, cfg.pool_batches)
    pool, corpus_pool = [], []
    for _ in range(n_unique):
        imgs, caps, cls = make_pairs(rng, cfg.batch_size, cfg.canvas, styles=cfg.styles,
                                     composed_frac=cfg.composed_frac)
        pool.append(tuple(torch.from_numpy(a).to(dev)
                          for a in (imgs, byte_tokenize(caps, mp), cls)))
        if corpus_w:
            corpus_pool.append(tuple(torch.from_numpy(a).to(dev) for a in
                                     word_context_batch(rng, cfg.text_corpus_batch, mp)))
    for i in range(cfg.steps):
        pixels, ids, cls = pool[i % n_unique]
        corpus = corpus_pool[i % n_unique] if corpus_w else None
        loss = optim.train_step(model, opt, lambda m: minisiglip_loss(
            m, pixels, ids, cls, corpus, corpus_w))
        if on_step is not None:
            on_step(i, loss)
        if cfg.log_every and (i % cfg.log_every == 0 or i == cfg.steps - 1):
            logger.info("minisiglip step %d loss %.4f", i, float(loss))
    return init_laws.state_of(model)


def save_minisiglip(state: dict, out_dir, vision_cfg: SigLIPVisionConfig,
                    text_cfg: SigLIPTextConfig, metrics: Optional[dict] = None) -> None:
    """``minisiglip_config.json`` and ``params.npz`` (the JAX tree's flat
    npz, without the ``params`` level) of the model's state dict, as JAX
    writes them."""
    from dataclasses import asdict

    from gvl_tpu_torch.models.convert import tree_from_state
    from gvl_tpu_torch.training.init_laws import minisiglip_layout, shapes
    from gvl_tpu_torch.utils.checkpoints import save_flat_npz

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "minisiglip_config.json").write_text(json.dumps({
        "vision": asdict(vision_cfg), "text": asdict(text_cfg),
        "metrics": metrics or {}}, indent=2))
    save_flat_npz(tree_from_state(_minisiglip_from_jax(vision_cfg, text_cfg),
                                  shapes(minisiglip_layout(vision_cfg, text_cfg)), state),
                  out / "params.npz")


def minisiglip_from_state(state: dict, vision_cfg: SigLIPVisionConfig,
                          text_cfg: SigLIPTextConfig, device) -> MiniSigLIP:
    """A :class:`MiniSigLIP` in eval mode on ``device`` holding ``state``."""
    from gvl_tpu_torch.nn.layers import load_module

    with torch.device("meta"):
        model = MiniSigLIP(vision_cfg, text_cfg)
    return load_module(model, state, resolve_device(device))


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
               canonical_captions: bool = False, composed_frac: float = 0.0
               ) -> tuple[np.ndarray, list[str], np.ndarray]:
    """n (crop, caption, class_id) pairs: ~72% entity crops, ~18%
    background, ~10% UI furniture; captions from the class pool (with
    probability ``composed_frac`` from the compositional space), or the
    canonical prompt for evaluation."""
    images = np.zeros((n, canvas, canvas, 3), np.uint8)
    captions: list[str] = []
    class_ids = np.zeros(n, np.int32)

    def caption(concept: str) -> str:
        if canonical_captions:
            return CAPTIONS[concept][0]
        if composed_frac and rng.random() < composed_frac:
            return compose_caption(concept, rng)
        return str(rng.choice(CAPTIONS[concept]))

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
