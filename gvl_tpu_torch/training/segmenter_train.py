"""The segmenter's concept signatures and synthetic scenes (the port's copy
of ``CONCEPT_SPECS``, ``make_scene`` and what it draws with from
``gvl_tpu.training.segmenter_train``): the shape and colour each concept is
drawn with in the synthetic ``concept_demo`` clips, the ones the shipped
segmenter checkpoint was trained on, and the procedural scenes with
ground-truth masks that the open-vocabulary figures
(:func:`gvl_tpu_torch.training.siglip_train.evaluate_open_vocab`) score.
The same seed draws the same scene as the JAX package.  The trainer stays
in the JAX package."""

from __future__ import annotations

import numpy as np

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
