"""Train the promptable segmenter on synthetic gameplay scenes (counterpart
of :mod:`gvl_tpu.training.segmenter_train`).

The concept signatures (the shape and colour each concept is drawn with in
the synthetic ``concept_demo`` clips), the procedural scenes with
ground-truth masks (:func:`make_scene`, which the open-vocabulary figures
of :func:`gvl_tpu_torch.training.siglip_train.evaluate_open_vocab` score
too), and the trainer of :class:`~gvl_tpu_torch.models.sam.
PromptableSegmenter`: a set-prediction loss whose queries are matched to
the ground-truth instances greedily by soft-dice cost (matched queries pay
dice + BCE on the mask and a score target of 1, the rest a score target
of 0), AdamW over a cosine schedule, and a pool of ``pool_batches``
batches indexed ``step % pool`` as in JAX.  The same seed draws the same
scenes and batches as the JAX package; the weights are drawn by Flax's
laws (:mod:`~gvl_tpu_torch.training.init_laws`).  Every attention of the
model goes through the flash kernel's differentiable wrapper.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

# concept → drawing signature (shape kind, RGB base). Distinctive per
# concept so open-vocab selection is learnable from scratch.
CONCEPT_SPECS: dict[str, tuple[str, tuple[int, int, int]]] = {
    "player": ("square", (60, 90, 220)),
    "enemy": ("triangle", (220, 60, 50)),
    "boss": ("ellipse", (160, 60, 200)),
    "item": ("diamond", (230, 200, 50)),
}
CONCEPTS = tuple(CONCEPT_SPECS)
MAX_INST = 3  # static per-(frame, concept) instance slots


@dataclass
class SegTrainConfig:
    image_size: int = 256
    steps: int = 1500
    batch_size: int = 8
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    seed: int = 0
    log_every: int = 100
    # max instances drawn per concept per frame (boss capped at 1)
    max_draw: int = 2
    # style families sampled during training — "holdout" must never
    # appear here (it is the out-of-distribution eval family)
    styles: tuple[str, ...] = ("base", "aug")
    # distinct batches of the pool (held on the device)
    pool_batches: int = 192


def _draw(kind: str, canvas: np.ndarray, mask: np.ndarray,
          cx: int, cy: int, r: int, color: np.ndarray) -> None:
    h, w = mask.shape
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "square":
        hit = (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r)
    elif kind == "triangle":
        hit = ((yy >= cy - r) & (yy <= cy + r)
               & (np.abs(xx - cx) <= (yy - (cy - r)) / 2))
    elif kind == "ellipse":
        hit = (((xx - cx) / max(r, 1)) ** 2
               + ((yy - cy) / max(r * 0.7, 1)) ** 2) <= 1.0
    else:  # diamond
        hit = (np.abs(xx - cx) + np.abs(yy - cy)) <= r
    canvas[hit] = color
    mask |= hit


STYLES = ("base", "aug", "holdout")


def _draw_styled(kind: str, frame: np.ndarray, mask: np.ndarray,
                 cx: int, cy: int, r: int, color: np.ndarray,
                 rng: np.random.Generator, style: str) -> None:
    """Concept signature (shape + base color) rendered in a style family:
    filled (base), gradient/outlined (aug), washed ring-fill (holdout).
    The GT mask is always the full shape extent."""
    h, w = mask.shape
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "square":
        hit = (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r)
        inner = (np.abs(xx - cx) <= r - 3) & (np.abs(yy - cy) <= r - 3)
    elif kind == "triangle":
        hit = ((yy >= cy - r) & (yy <= cy + r)
               & (np.abs(xx - cx) <= (yy - (cy - r)) / 2))
        inner = ((yy >= cy - r + 3) & (yy <= cy + r - 3)
                 & (np.abs(xx - cx) <= (yy - (cy - r + 3)) / 2 - 1))
    elif kind == "ellipse":
        hit = (((xx - cx) / max(r, 1)) ** 2
               + ((yy - cy) / max(r * 0.7, 1)) ** 2) <= 1.0
        inner = (((xx - cx) / max(r - 3, 1)) ** 2
                 + ((yy - cy) / max((r - 3) * 0.7, 1)) ** 2) <= 1.0
    else:  # diamond
        hit = (np.abs(xx - cx) + np.abs(yy - cy)) <= r
        inner = (np.abs(xx - cx) + np.abs(yy - cy)) <= r - 3
    fill = np.asarray(color, np.float32)
    if style == "base":
        frame[hit] = color
    elif style == "aug":
        # domain randomization over independent rendering dimensions —
        # fill mode × wash strength × ring emphasis — so the model keys
        # on shape + relative color, not the absolute base palette.
        # The holdout family stays OUT of distribution two ways: its
        # parameter point (wash 0.55/+90, ring 1.2/+30) lies OUTSIDE
        # every training range below (an extrapolation per dimension),
        # and its composition (that rendering on checkerboard with ring
        # distractors + wide gamma warp) is never sampled.
        mode = rng.random()
        if mode < 0.25:      # vertical gradient fill
            grad = 0.55 + 0.45 * np.clip(
                (yy - (cy - r)) / max(2 * r, 1), 0, 1)
            frame[hit] = np.clip(
                fill[None] * grad[hit][:, None], 0, 255).astype(np.uint8)
        elif mode < 0.45:    # outline-only rendering
            ring = hit & ~inner
            frame[ring] = color
            frame[inner] = np.clip(fill * rng.uniform(0.2, 0.5), 0, 255
                                   ).astype(np.uint8)
        elif mode < 0.75:    # washed interior + emphasized outline
            # training sub-ranges exclude the holdout point: mul>=0.65
            # (holdout 0.55), add<=70 (holdout 90), ring mul<=1.15
            # (holdout 1.2), ring add>=40 (holdout 30)
            ring = hit & ~inner
            frame[inner] = np.clip(
                fill * rng.uniform(0.65, 0.9) + rng.uniform(20, 70),
                0, 255).astype(np.uint8)
            frame[ring] = np.clip(
                fill * rng.uniform(1.0, 1.15) + rng.uniform(40, 80),
                0, 255).astype(np.uint8)
        else:
            frame[hit] = color
    else:  # holdout: washed fill + bright ring, never seen in training
        ring = hit & ~inner
        washed = np.clip(fill * 0.55 + 90.0, 0, 255).astype(np.uint8)
        frame[inner] = washed
        frame[ring] = np.clip(fill * 1.2 + 30, 0, 255).astype(np.uint8)
    mask |= hit


def make_scene(
    rng: np.random.Generator, size: int, max_draw: int = 2,
    style: str = "base",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One scene: (uint8 frame [S,S,3], gt_masks [C,I,S,S] bool,
    gt_valid [C,I] bool).  Includes concept-free distractor shapes.

    ``style`` selects a rendering family.  "base" is the round-2
    distribution; "aug" adds gradients/outlines/striped backgrounds
    (used in training); "holdout" is a family the trainer NEVER samples
    (checkerboard backgrounds, washed ring-rendered entities, ring
    distractors, gamma warp) — the out-of-distribution transfer proxy
    while real gameplay data is unreachable (VERDICT r2 #8)."""
    yy, xx = np.mgrid[0:size, 0:size]
    if style == "holdout":
        tile = int(rng.integers(14, 34))
        c0 = rng.integers(10, 55, 3).astype(np.float32)
        c1 = rng.integers(35, 95, 3).astype(np.float32)
        checker = ((yy // tile + xx // tile) % 2).astype(np.float32)
        frame = (c0[None, None] * (1 - checker[..., None])
                 + c1[None, None] * checker[..., None]).astype(np.uint8)
        grid = ((yy % tile == 0) | (xx % tile == 0))
        frame[grid] = np.clip(frame[grid].astype(np.int32) + 40, 0, 255
                              ).astype(np.uint8)
    elif style == "aug" and rng.random() < 0.65:
        # structured backgrounds — none is the holdout's two-color
        # axis-aligned checkerboard-with-grid-lines
        kind = rng.random()
        if kind < 0.4:       # diagonal stripes
            period = int(rng.integers(8, 24))
            stripes = (((yy + xx) // period) % 2).astype(np.uint8)
            lo = rng.integers(15, 50, 3)
            hi = rng.integers(40, 100, 3)
            frame = (lo[None, None] + (hi - lo)[None, None]
                     * stripes[..., None]).astype(np.uint8)
        elif kind < 0.75:    # random-colored tile mosaic
            tile = int(rng.integers(16, 48))
            nt = size // tile + 1
            palette = rng.integers(10, 110, (nt, nt, 3))
            frame = palette[yy // tile, xx // tile].astype(np.uint8)
            if rng.random() < 0.5:   # bright mortar seams
                seam = ((yy % tile == 0) | (xx % tile == 0))
                frame[seam] = np.clip(
                    frame[seam].astype(np.int32)
                    + int(rng.integers(30, 60)), 0, 255).astype(np.uint8)
        else:                # dotted grid on a dark field
            frame = rng.integers(15, 45, (1, 1, 3)).astype(np.uint8)
            frame = np.broadcast_to(frame, (size, size, 3)).copy()
            period = int(rng.integers(12, 28))
            dots = ((yy % period < 3) & (xx % period < 3))
            frame[dots] = rng.integers(50, 110, 3).astype(np.uint8)
    else:
        frame = rng.integers(15, 70, (size, size, 3)).astype(np.uint8)
        # background texture: a few dim rectangles
        for _ in range(rng.integers(2, 5)):
            x, y = rng.integers(0, size, 2)
            w, h = rng.integers(10, size // 3, 2)
            frame[y:y + h, x:x + w] = rng.integers(20, 90, 3)

    gt_masks = np.zeros((len(CONCEPTS), MAX_INST, size, size), bool)
    gt_valid = np.zeros((len(CONCEPTS), MAX_INST), bool)
    for ci, concept in enumerate(CONCEPTS):
        kind, base = CONCEPT_SPECS[concept]
        cap = 1 if concept == "boss" else max_draw
        count = int(rng.integers(0, cap + 1))
        for i in range(count):
            lo = max(3, size // 18)
            hi = max(lo + 2, size // 8 if concept != "boss" else size // 5)
            r = int(rng.integers(lo, hi))
            cx = int(rng.integers(r, size - r))
            cy = int(rng.integers(r, size - r))
            jitter = rng.integers(-25, 26, 3)
            color = np.clip(np.asarray(base) + jitter, 0, 255
                            ).astype(np.uint8)
            m = np.zeros((size, size), bool)
            _draw_styled(kind, frame, m, cx, cy, r, color, rng, style)
            gt_masks[ci, i] = m
            gt_valid[ci, i] = True
    # distractors: concept-free shapes drawn OVER the entities so some
    # instances are partially occluded (the GT mask keeps the full
    # extent, teaching amodal robustness)
    for _ in range(rng.integers(1, 4)):
        lo = max(2, size // 32)
        r = int(rng.integers(lo, max(lo + 2, size // 13)))
        cx, cy = rng.integers(r, size - r, 2)
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        if style == "holdout":   # circle rings, not disks
            hit = (d2 <= r * r) & (d2 >= (max(r - 3, 1)) ** 2)
        elif style == "aug" and rng.random() < 0.4:
            # hollow SQUARE outlines: teaches "unfilled shapes are not
            # entities" without sampling the holdout's circle rings
            w = int(rng.integers(2, 4))
            outer = (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r)
            hole = (np.abs(xx - cx) <= r - w) & (np.abs(yy - cy) <= r - w)
            hit = outer & ~hole
        else:
            hit = d2 <= r * r
        frame[hit] = rng.integers(110, 160, 3).astype(np.uint8)
    # HUD furniture negatives: thin status bars + glyph rows overlaid in
    # saturated — sometimes concept-colored — palettes.  Gameplay UIs
    # draw these everywhere and they must not read as entities: the v3
    # checkpoint (no such negatives) detected concept_demo's red HP bar
    # as "enemy" (shape lost to color under style randomization).  Kept
    # out of the holdout family so its OOD definition is unchanged.
    if style != "holdout" and rng.random() < 0.7:
        for _ in range(rng.integers(1, 3)):
            bh = int(rng.integers(4, 10))
            bw = int(rng.integers(size // 5, size // 2))
            bx = int(rng.integers(0, size - bw))
            by = int(rng.integers(0, size - bh))
            if rng.random() < 0.5:   # concept-palette bar (hard negative)
                base_c = np.asarray(CONCEPT_SPECS[
                    CONCEPTS[int(rng.integers(len(CONCEPTS)))]][1],
                    np.int64)
                col = np.clip(base_c + rng.integers(-30, 31, 3), 0, 255)
            else:
                col = rng.integers(120, 256, 3)
            fill = int(rng.integers(bw // 4, bw + 1))
            frame[by:by + bh, bx:bx + fill] = col.astype(np.uint8)
            frame[by:by + bh, bx + fill:bx + bw] = (60, 60, 60)
        if rng.random() < 0.6:       # glyph row (text-like clutter)
            gh = int(rng.integers(6, 14))
            gy = int(rng.integers(0, size - gh))
            gx = int(rng.integers(0, size // 2))
            bright = rng.integers(170, 256, 3).astype(np.uint8)
            x = gx
            for _ in range(int(rng.integers(4, 12))):
                gw = int(rng.integers(2, max(3, gh // 2 + 2)))
                if x + gw >= size:
                    break
                frame[gy:gy + gh, x:x + gw] = bright
                x += gw + int(rng.integers(1, 4))
    # global perturbations per style family
    if style == "holdout":
        gamma = rng.uniform(0.75, 1.3)
        warped = 255.0 * (frame.astype(np.float32) / 255.0) ** gamma
        noise = rng.normal(0, 8, frame.shape)
        frame = np.clip(warped + noise, 0, 255).astype(np.uint8)
    else:
        gain = rng.uniform(0.8, 1.2)
        sigma = rng.uniform(2, 12) if style == "aug" else 6
        out = frame.astype(np.float32)
        if style == "aug" and rng.random() < 0.6:
            # photometric gamma randomization (global transform — the
            # holdout's OOD-ness rests on rendering + composition, not
            # on gamma alone)
            out = 255.0 * (out / 255.0) ** rng.uniform(0.7, 1.4)
        noise = rng.normal(0, sigma, frame.shape)
        frame = np.clip(out * gain + noise, 0, 255).astype(np.uint8)
    return frame, gt_masks, gt_valid


def make_batch(rng: np.random.Generator, cfg: SegTrainConfig, model_cfg
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(frames uint8 [B,S,S,3], gt bool [B,C,I,ms,ms], valid [B,C,I])."""
    ms = model_cfg.image_size // model_cfg.mask_downscale
    stride = model_cfg.mask_downscale
    frames, gts, valids = [], [], []
    for _ in range(cfg.batch_size):
        style = cfg.styles[int(rng.integers(0, len(cfg.styles)))]
        frame, gt, valid = make_scene(rng, cfg.image_size, cfg.max_draw, style=style)
        frames.append(frame)
        gts.append(gt[:, :, ::stride, ::stride][:, :, :ms, :ms])
        valids.append(valid)
    return np.stack(frames), np.stack(gts), np.stack(valids)


# --------------------------------------------------------------------------
# Set-prediction loss (greedy dice matching over static instance slots)
# --------------------------------------------------------------------------

def _dice(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Soft dice ∈ [0,1] between sigmoid-probs and {0,1} targets over the
    last two axes (broadcast over leading)."""
    inter = (pred * gt).sum((-2, -1))
    union = pred.sum((-2, -1)) + gt.sum((-2, -1))
    return 1.0 - (2.0 * inter + 1.0) / (union + 1.0)


def match_queries(logits: torch.Tensor, gt_masks: torch.Tensor,
                  gt_valid: torch.Tensor) -> torch.Tensor:
    """The query matched to each instance slot, ``[B, C, MAX_INST]``: in slot
    order, the untaken query of least dice cost (``argmin``, the first on
    ties and on rows that are all ``inf``, as ``jnp.argmin``); a slot
    without an instance takes nothing.  No gradient flows through it."""
    with torch.no_grad():
        probs = torch.sigmoid(logits.detach())
        cost = _dice(probs[:, :, :, None], gt_masks[:, :, None])
        cost = torch.where(gt_valid[:, :, None, :], cost, torch.inf)
        taken = torch.zeros(probs.shape[:3], dtype=torch.bool, device=logits.device)
        picks = []
        for i in range(MAX_INST):
            qi = torch.where(taken, torch.inf, cost[..., i]).argmin(-1)
            pick = torch.nn.functional.one_hot(qi, taken.shape[-1]).bool()
            taken |= pick & gt_valid[..., i, None]
            picks.append(qi)
        return torch.stack(picks, -1)


def segmentation_loss(out: dict, gt_masks: torch.Tensor,
                      gt_valid: torch.Tensor) -> torch.Tensor:
    """out: mask_logits [B,C,Q,h,w], scores [B,C,Q] (already sigmoid);
    gt_masks [B,C,I,h,w] (f32); gt_valid [B,C,I]."""
    logits = out["mask_logits"]
    scores = out["scores"].clamp(1e-6, 1.0 - 1e-6)
    q = scores.shape[-1]
    matches = match_queries(logits, gt_masks, gt_valid)
    matched_q = torch.zeros(scores.shape, dtype=torch.bool, device=logits.device)
    total_mask_loss = logits.new_zeros(())
    n_matched = logits.new_zeros(())
    for i in range(MAX_INST):
        valid_i = gt_valid[..., i]
        pick = torch.nn.functional.one_hot(matches[..., i], q).bool() & valid_i[..., None]
        matched_q |= pick
        sel = torch.einsum("bcqhw,bcq->bchw", logits, pick.to(logits.dtype))
        gt_i = gt_masks[:, :, i]
        bce = (sel.clamp(min=0) - sel * gt_i + torch.log1p(torch.exp(-sel.abs()))).mean((-2, -1))
        dice_i = _dice(torch.sigmoid(sel), gt_i)
        total_mask_loss = total_mask_loss + torch.where(valid_i, bce + dice_i, 0.0).sum()
        n_matched = n_matched + valid_i.sum()
    # balanced score BCE: positives and negatives averaged separately
    pos = matched_q
    bce_all = -torch.where(pos, torch.log(scores), torch.log1p(-scores))
    n_pos = pos.sum().clamp(min=1.0)
    n_neg = (~pos).sum().clamp(min=1.0)
    score_loss = (torch.where(pos, bce_all, 0.0).sum() / n_pos
                  + torch.where(pos, 0.0, bce_all).sum() / n_neg)
    return total_mask_loss / n_matched.clamp(min=1.0) + score_loss


# --------------------------------------------------------------------------
# Training / evaluation
# --------------------------------------------------------------------------

def concept_tokens(model_cfg, device) -> torch.Tensor:
    """The four concepts' hashed prompts ``[C, 16]`` on ``device``."""
    from gvl_tpu_torch.models.sam import hash_tokenize

    return torch.from_numpy(np.stack([hash_tokenize(c, model_cfg.text_vocab)
                                      for c in CONCEPTS])).to(device)


def segmenter_loss(model, tokens: torch.Tensor, frames_u8: torch.Tensor,
                   gt_bool: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The trainer's loss on one batch (uint8 frames, bool masks), on the
    model's device."""
    from gvl_tpu_torch.ops.quant_matmul import true_div

    frames = true_div(frames_u8.float(), 255.0)
    return segmentation_loss(model(frames, tokens), gt_bool.float(), valid)


def segmenter_state(params: Optional[dict], model_cfg, seed: int) -> dict:
    """The weights a run starts from: ``params`` (the port's state dict or
    the JAX package's variables) or, without it, drawn from ``seed`` by
    Flax's laws."""
    from gvl_tpu_torch.models.convert import sam_params_from_jax
    from gvl_tpu_torch.training import init_laws

    convert = lambda tree: sam_params_from_jax(tree, model_cfg)
    if params is not None:
        return init_laws.as_state(params, convert)
    return init_laws.init_params(convert, init_laws.sam_layout(model_cfg), seed)


def train_segmenter(model_cfg=None, cfg: Optional[SegTrainConfig] = None,
                    init_params: Optional[dict] = None, device="cuda",
                    on_step=None) -> dict[str, torch.Tensor]:
    """Train ``PromptableSegmenter(model_cfg)`` and return its f32 state dict
    (JAX's ``train_segmenter``; ``init_params`` warm-starts it,
    ``on_step(i, loss)`` sees each step's loss on the device)."""
    from gvl_tpu_torch import resolve_device
    from gvl_tpu_torch.models.sam import PromptableSegmenter, SamConfig
    from gvl_tpu_torch.training import init_laws, optim

    model_cfg = model_cfg or SamConfig()
    cfg = cfg or SegTrainConfig(image_size=model_cfg.image_size)
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    with torch.device("meta"):
        model = PromptableSegmenter(model_cfg)
    model = init_laws.trainable(model, segmenter_state(init_params, model_cfg, cfg.seed), dev)
    opt = optim.AdamW(model.parameters(), optim.cosine_decay_schedule(
        cfg.learning_rate, cfg.steps), clip=None, weight_decay=cfg.weight_decay)
    tokens = concept_tokens(model_cfg, dev)

    n_unique = min(cfg.steps, cfg.pool_batches)
    pool = [tuple(torch.from_numpy(a).to(dev) for a in make_batch(rng, cfg, model_cfg))
            for _ in range(n_unique)]
    for i in range(cfg.steps):
        batch = pool[i % n_unique]
        loss = optim.train_step(model, opt, lambda m: segmenter_loss(m, tokens, *batch))
        if on_step is not None:
            on_step(i, loss)
        if cfg.log_every and (i % cfg.log_every == 0 or i == cfg.steps - 1):
            logger.info("step %d loss %.4f", i, float(loss))
    return init_laws.state_of(model)


@torch.inference_mode()
def evaluate_segmenter(params: dict, model_cfg=None, n_scenes: int = 32, seed: int = 1234,
                       score_threshold: float = 0.5, style: str = "base",
                       device="cuda") -> dict:
    """Held-out synthetic eval: per-GT-instance best IoU over predictions
    that clear the score threshold (``params``: a state dict or the JAX
    package's variables).  ``style="holdout"`` evaluates the never-trained
    rendering family."""
    from gvl_tpu_torch import resolve_device
    from gvl_tpu_torch.models.sam import PromptableSegmenter, SamConfig
    from gvl_tpu_torch.nn.layers import load_module

    model_cfg = model_cfg or SamConfig()
    dev = resolve_device(device)
    with torch.device("meta"):
        model = PromptableSegmenter(model_cfg)
    model = load_module(model, segmenter_state(params, model_cfg, 0), dev)
    rng = np.random.default_rng(seed)
    tokens = concept_tokens(model_cfg, dev)
    ms = model_cfg.image_size // model_cfg.mask_downscale
    stride = model_cfg.mask_downscale
    ious, detected, total = [], 0, 0
    for _ in range(n_scenes):
        frame, gt_masks, gt_valid = make_scene(rng, model_cfg.image_size, style=style)
        out = model(torch.from_numpy(frame[None].astype(np.float32) / 255.0).to(dev), tokens)
        probs = (torch.sigmoid(out["mask_logits"]) > 0.5).cpu().numpy()[0]
        scores = out["scores"].float().cpu().numpy()[0]
        gt_small = gt_masks[:, :, ::stride, ::stride][:, :, :ms, :ms]
        for ci in range(len(CONCEPTS)):
            live = scores[ci] >= score_threshold
            for i in range(MAX_INST):
                if not gt_valid[ci, i]:
                    continue
                total += 1
                gt = gt_small[ci, i]
                best = 0.0
                for qi in range(probs.shape[1]):
                    if not live[qi]:
                        continue
                    inter = (probs[ci, qi] & gt).sum()
                    union = (probs[ci, qi] | gt).sum()
                    best = max(best, inter / union if union else 0.0)
                ious.append(best)
                if best >= 0.5:
                    detected += 1
    return {
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
        "detection_rate_at_50": detected / total if total else 0.0,
        "instances": total,
    }
