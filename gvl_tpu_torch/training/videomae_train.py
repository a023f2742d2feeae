"""The self-trained temporal clip encoder and its trainer (counterpart of
:mod:`gvl_tpu.training.videomae_train`).

The mini VideoMAE tower of ``outputs/videomae`` (256 wide x 6 layers x 4
heads, 16 frames at 112 px) with its three linear heads on the mean-pooled
clip token: the primary entity's motion direction (static + 8 compass
points), its concept kind and an appearance event.  The pipeline turns
confident directions into TEMPORAL timeline events
(:func:`gvl_tpu_torch.temporal.clip_encoder.extract_clip_embeddings`).  As
in JAX the pixels are rounded to bf16 and the f32 tower computes in f32; its
attention goes through the flash kernel (head 64 over 392 tokens).  The
procedural clips (:func:`make_clip`, :func:`make_batch`) and
:func:`evaluate_clip_encoder` reproduce the JAX module's figures, and
:func:`train_clip_encoder` trains the classifier on them (the sum of the
three heads' cross-entropies, AdamW over a cosine schedule, a pool of
``pool_batches`` uint8 batches indexed ``step % pool``), rounding the
normalised pixels to bf16 into the f32 tower as JAX's step does.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.videomae import VideoMAEConfig, VideoMAEEncoder
from gvl_tpu_torch.training.segmenter_train import CONCEPT_SPECS, _draw_styled

CONCEPTS = tuple(CONCEPT_SPECS)

logger = logging.getLogger(__name__)

# 9-way motion label: index 0 is static, then 8 compass directions as
# (dx, dy) unit steps (y grows downward, "N" = up).
DIRECTIONS: tuple[tuple[str, tuple[float, float]], ...] = (
    ("static", (0.0, 0.0)),
    ("N", (0.0, -1.0)),
    ("NE", (0.707, -0.707)),
    ("E", (1.0, 0.0)),
    ("SE", (0.707, 0.707)),
    ("S", (0.0, 1.0)),
    ("SW", (-0.707, 0.707)),
    ("W", (-1.0, 0.0)),
    ("NW", (-0.707, -0.707)),
)
DIRECTION_NAMES = tuple(name for name, _ in DIRECTIONS)
EVENTS = ("none", "appears", "vanishes")

# compass → timeline-event phrasing ("the player moving up-right")
DIRECTION_PHRASES = {
    "static": "holding position", "N": "moving up",
    "NE": "moving up-right", "E": "moving right",
    "SE": "moving down-right", "S": "moving down",
    "SW": "moving down-left", "W": "moving left",
    "NW": "moving up-left",
}

# ImageNet normalization, as the HF rung's preprocessing
_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


# --------------------------------------------------------------------------
# Procedural animated clips with ground truth
# --------------------------------------------------------------------------

def _background(rng: np.random.Generator, size: int, n_frames: int,
                style: str) -> np.ndarray:
    """[T, S, S, 3] uint8 backgrounds per style family."""
    if style == "holdout":
        # checkerboard — never sampled in training (segmenter playbook)
        cell = int(rng.integers(12, 22))
        yy, xx = np.mgrid[0:size, 0:size]
        checker = ((yy // cell + xx // cell) % 2).astype(np.float32)
        a, b = rng.uniform(20, 60), rng.uniform(70, 110)
        base = (a + (b - a) * checker)[..., None].repeat(3, axis=-1)
    elif style == "aug" and rng.random() < 0.5:
        # vertical gradient
        lo, hi = rng.uniform(10, 50), rng.uniform(60, 120)
        col = np.linspace(lo, hi, size, dtype=np.float32)
        base = col[:, None, None].repeat(size, 1).repeat(3, 2)
    elif style == "aug" and rng.random() < 0.5:
        # mosaic blocks
        cell = int(rng.integers(16, 33))
        n = size // cell + 1
        blocks = rng.uniform(15, 95, (n, n, 3)).astype(np.float32)
        base = np.kron(blocks, np.ones((cell, cell, 1), np.float32))
        base = base[:size, :size]
    else:
        base = np.full((size, size, 3), rng.uniform(15, 70), np.float32)
    frames = np.empty((n_frames, size, size, 3), np.float32)
    for t in range(n_frames):
        noise = rng.normal(0.0, 4.0, (size, size, 1)).astype(np.float32)
        gain = 1.0
        if style == "aug":
            gain = float(rng.uniform(0.9, 1.1))  # per-frame flicker
        frames[t] = np.clip(base * gain + noise, 0, 255)
    return frames.astype(np.uint8)


def make_clip(
    rng: np.random.Generator,
    size: int = 112,
    n_frames: int = 16,
    style: str = "base",
) -> tuple[np.ndarray, dict]:
    """One animated clip: (uint8 [T, S, S, 3], labels).

    labels = {"direction": int, "kind": int, "event": int}.  The primary
    entity carries the segmenter's concept signature (shape + base
    color); distractors are concept-free gray shapes with their own
    motion, so the model must BIND motion to the concept entity rather
    than pool global flow.
    """
    clip = _background(rng, size, n_frames, style)

    dir_idx = int(rng.integers(0, len(DIRECTIONS)))
    _, (ux, uy) = DIRECTIONS[dir_idx]
    speed = 0.0 if dir_idx == 0 else float(rng.uniform(2.0, 4.5))
    r = int(rng.integers(9, 16))

    event_idx = int(rng.integers(0, len(EVENTS)))
    # event frame: keep ≥1/4 of the clip on each side so both the
    # before- and after-state are visible (and short test clips stay
    # valid)
    k_lo = max(1, n_frames // 4)
    k_hi = max(k_lo + 1, n_frames - n_frames // 4)
    k = int(rng.integers(k_lo, k_hi)) if event_idx else 0

    # start position such that the full trajectory stays in bounds
    dx, dy = ux * speed, uy * speed
    margin = r + 2
    lo_x = margin + max(0.0, -dx * (n_frames - 1))
    hi_x = size - margin - max(0.0, dx * (n_frames - 1))
    lo_y = margin + max(0.0, -dy * (n_frames - 1))
    hi_y = size - margin - max(0.0, dy * (n_frames - 1))
    if hi_x <= lo_x or hi_y <= lo_y:  # too fast for the canvas: slow down
        speed *= 0.6
        dx, dy = ux * speed, uy * speed
        lo_x = margin + max(0.0, -dx * (n_frames - 1))
        hi_x = size - margin - max(0.0, dx * (n_frames - 1))
        lo_y = margin + max(0.0, -dy * (n_frames - 1))
        hi_y = size - margin - max(0.0, dy * (n_frames - 1))
    x0 = float(rng.uniform(lo_x, max(lo_x + 1.0, hi_x)))
    y0 = float(rng.uniform(lo_y, max(lo_y + 1.0, hi_y)))

    kind_idx = int(rng.integers(0, len(CONCEPTS)))
    shape, color = CONCEPT_SPECS[CONCEPTS[kind_idx]]
    color = np.asarray(color, np.uint8)

    # concept-free moving distractors (mid-gray: outside every concept's
    # color signature)
    distractors = []
    for _ in range(int(rng.integers(0, 3))):
        g = rng.uniform(90, 150, 3)
        d_dir = DIRECTIONS[int(rng.integers(1, len(DIRECTIONS)))][1]
        d_speed = float(rng.uniform(1.0, 3.0))
        distractors.append((
            str(rng.choice(["square", "triangle", "ellipse", "diamond"])),
            np.clip(g, 0, 255).astype(np.uint8),
            float(rng.uniform(margin, size - margin)),
            float(rng.uniform(margin, size - margin)),
            int(rng.integers(7, 13)),
            d_dir[0] * d_speed, d_dir[1] * d_speed,
        ))

    scratch = np.zeros((size, size), bool)
    for t in range(n_frames):
        frame = clip[t]
        for d_shape, d_col, d_x0, d_y0, d_r, ddx, ddy in distractors:
            cx = int(np.clip(d_x0 + ddx * t, d_r, size - d_r - 1))
            cy = int(np.clip(d_y0 + ddy * t, d_r, size - d_r - 1))
            scratch[:] = False
            _draw_styled(d_shape, frame, scratch, cx, cy, d_r,
                         d_col, rng, style)
        visible = (event_idx == 0 or
                   (event_idx == 1 and t >= k) or
                   (event_idx == 2 and t < k))
        if visible:
            scratch[:] = False
            _draw_styled(shape, frame, scratch,
                         int(round(x0 + dx * t)), int(round(y0 + dy * t)),
                         r, color, rng, style)
        if style == "holdout":  # wide gamma warp, never trained
            gamma = 0.6 + 0.8 * ((t * 37) % 7) / 6.0
            frame[:] = (np.clip(frame.astype(np.float32) / 255.0, 0, 1)
                        ** gamma * 255).astype(np.uint8)
    labels = {"direction": dir_idx, "kind": kind_idx, "event": event_idx}
    return clip, labels


def make_batch(rng: np.random.Generator, n: int, size: int, n_frames: int,
               styles: tuple[str, ...]) -> tuple[np.ndarray, np.ndarray,
                                                 np.ndarray, np.ndarray]:
    clips, dirs, kinds, events = [], [], [], []
    for _ in range(n):
        style = styles[int(rng.integers(0, len(styles)))]
        clip, lab = make_clip(rng, size, n_frames, style)
        clips.append(clip)
        dirs.append(lab["direction"])
        kinds.append(lab["kind"])
        events.append(lab["event"])
    return (np.stack(clips), np.asarray(dirs, np.int32),
            np.asarray(kinds, np.int32), np.asarray(events, np.int32))


# --------------------------------------------------------------------------
# Model: the VideoMAE tower at mini scale + task heads
# --------------------------------------------------------------------------

def mini_videomae_config(**kw) -> VideoMAEConfig:
    defaults = dict(hidden_size=256, intermediate_size=1024, num_layers=6,
                    num_heads=4, image_size=112, patch_size=16,
                    num_frames=16, tubelet_size=2)
    defaults.update(kw)
    return VideoMAEConfig(**defaults)


class ClipClassifier(nn.Module):
    """Encoder + linear task heads on the mean-pooled clip token."""

    def __init__(self, config: VideoMAEConfig):
        super().__init__()
        self.config = config
        self.encoder = VideoMAEEncoder(config)
        self.dir_head = nn.Linear(config.hidden_size, len(DIRECTIONS))
        self.kind_head = nn.Linear(config.hidden_size, len(CONCEPTS))
        self.event_head = nn.Linear(config.hidden_size, len(EVENTS))

    def forward(self, video: torch.Tensor):
        emb = self.encoder(video)["clip_embedding"]
        return emb, self.dir_head(emb), self.kind_head(emb), self.event_head(emb)


def build_classifier(model_cfg: VideoMAEConfig) -> ClipClassifier:
    return ClipClassifier(model_cfg)


def _normalize(pixels_u8: torch.Tensor) -> torch.Tensor:
    """uint8 → ImageNet-normalised f32, rounded to bf16 and computed in the
    weights' f32, as the JAX rung casts its input."""
    from gvl_tpu_torch.ops.quant_matmul import true_div

    mean = torch.tensor(_MEAN, device=pixels_u8.device)
    std = torch.tensor(_STD, device=pixels_u8.device)
    x = (true_div(pixels_u8.float(), 255.0) - mean) / std
    return x.to(torch.bfloat16).float()


@dataclass
class ClipTrainConfig:
    steps: int = 4000
    batch_size: int = 16
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    seed: int = 0
    log_every: int = 200
    # uint8 batch pool held on the device (~1.2 GB at the defaults)
    pool_batches: int = 128
    styles: tuple[str, ...] = ("base", "aug")
    model: VideoMAEConfig = field(default_factory=mini_videomae_config)


def _classifier_from_jax(model_cfg: VideoMAEConfig):
    from gvl_tpu_torch.models.convert import clip_classifier_params_from_jax

    return lambda tree: clip_classifier_params_from_jax(tree, model_cfg)


def _classifier_layout(model_cfg: VideoMAEConfig) -> dict:
    from gvl_tpu_torch.training import init_laws

    return init_laws.clip_classifier_layout(
        model_cfg, (len(DIRECTIONS), len(CONCEPTS), len(EVENTS)))


def clip_state(params: Optional[dict], model_cfg: VideoMAEConfig, seed: int) -> dict:
    """The classifier's weights a run starts from: ``params`` (a state dict
    or the JAX tree) or, without it, drawn from ``seed`` by Flax's laws."""
    from gvl_tpu_torch.training import init_laws

    convert = _classifier_from_jax(model_cfg)
    if params is not None:
        return init_laws.as_state(params, convert)
    return init_laws.init_params(convert, _classifier_layout(model_cfg), seed)


def clip_loss(model: ClipClassifier, clips_u8: torch.Tensor, dirs: torch.Tensor,
              kinds: torch.Tensor, events: torch.Tensor) -> torch.Tensor:
    """The sum of the three heads' mean cross-entropies on one batch."""
    ce = nn.functional.cross_entropy
    _, d_log, k_log, e_log = model(_normalize(clips_u8))
    return (ce(d_log.float(), dirs.long()) + ce(k_log.float(), kinds.long())
            + ce(e_log.float(), events.long()))


def train_clip_encoder(cfg: Optional[ClipTrainConfig] = None,
                       init_params: Optional[dict] = None, device="cuda",
                       on_step=None) -> dict[str, torch.Tensor]:
    """Train the clip classifier and return its f32 state dict (JAX's
    ``train_clip_encoder``; ``on_step(i, loss)`` sees each step's loss on
    the device)."""
    from gvl_tpu_torch.training import init_laws, optim

    cfg = cfg or ClipTrainConfig()
    model_cfg = cfg.model
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    with torch.device("meta"):
        model = ClipClassifier(model_cfg)
    model = init_laws.trainable(model, clip_state(init_params, model_cfg, cfg.seed), dev)
    logger.info("clip classifier params: %.2fM",
                sum(p.numel() for p in model.parameters()) / 1e6)
    opt = optim.AdamW(model.parameters(), optim.cosine_decay_schedule(
        cfg.learning_rate, cfg.steps), clip=None, weight_decay=cfg.weight_decay)
    n_unique = min(cfg.steps, cfg.pool_batches)
    pool = [tuple(torch.from_numpy(a).to(dev) for a in make_batch(
        rng, cfg.batch_size, model_cfg.image_size, model_cfg.num_frames, cfg.styles))
        for _ in range(n_unique)]
    for i in range(cfg.steps):
        batch = pool[i % n_unique]
        loss = optim.train_step(model, opt, lambda m: clip_loss(m, *batch))
        if on_step is not None:
            on_step(i, loss)
        if cfg.log_every and (i % cfg.log_every == 0 or i == cfg.steps - 1):
            logger.info("clip step %d loss %.4f", i, float(loss))
    return init_laws.state_of(model)


def save_clip_encoder(state: dict, out_dir, model_cfg: Optional[VideoMAEConfig] = None,
                      metrics: Optional[dict] = None) -> None:
    """``params.npz`` (the JAX tree's flat npz) of the classifier's state
    dict and ``videomae_config.json``, as JAX writes them."""
    from dataclasses import asdict

    from gvl_tpu_torch.models.convert import tree_from_state
    from gvl_tpu_torch.training.init_laws import shapes
    from gvl_tpu_torch.utils.checkpoints import save_flat_npz

    model_cfg = model_cfg or mini_videomae_config()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_flat_npz(tree_from_state(_classifier_from_jax(model_cfg),
                                  shapes(_classifier_layout(model_cfg)), state),
                  out / "params.npz")
    meta = {"model": asdict(model_cfg), "directions": list(DIRECTION_NAMES),
            "concepts": list(CONCEPTS), "events": list(EVENTS)}
    if metrics:
        meta["metrics"] = metrics
    (out / "videomae_config.json").write_text(json.dumps(meta, indent=2))


def classifier_from_state(state: dict, model_cfg: VideoMAEConfig, device) -> ClipClassifier:
    """A classifier in eval mode on ``device`` holding ``state`` (a state
    dict or the JAX tree)."""
    from gvl_tpu_torch.nn.layers import load_module

    with torch.device("meta"):
        model = ClipClassifier(model_cfg)
    return load_module(model, clip_state(state, model_cfg, 0), resolve_device(device))


def load_clip_encoder(ckpt_dir, device: str | torch.device = "cuda"
                      ) -> tuple[VideoMAEConfig, ClipClassifier]:
    """(config, classifier in eval mode on ``device``) of a trained
    directory (``videomae_config.json`` and the flat-npz ``params.npz``)."""
    from gvl_tpu_torch.models.convert import clip_classifier_params_from_jax
    from gvl_tpu_torch.nn.layers import load_module
    from gvl_tpu_torch.utils.checkpoints import load_flat_npz

    device = resolve_device(device)
    ckpt = Path(ckpt_dir)
    raw = json.loads((ckpt / "videomae_config.json").read_text())
    cfg = VideoMAEConfig(**{k: v for k, v in raw["model"].items()
                            if k in VideoMAEConfig.__dataclass_fields__})
    state = clip_classifier_params_from_jax(load_flat_npz(ckpt / "params.npz"), cfg)
    with torch.device("meta"):
        model = ClipClassifier(cfg)
    return cfg, load_module(model, state, device)


def is_trained_clip_checkpoint(path) -> bool:
    return bool(path) and (Path(path) / "videomae_config.json").exists()


@torch.inference_mode()
def evaluate_clip_encoder(model: ClipClassifier, n_clips: int = 160, seed: int = 1234,
                          style: str = "base", shuffle_frames: bool = False) -> dict:
    """Per-factor accuracy; ``shuffle_frames=True`` is the temporal control
    (direction accuracy on moving clips should collapse toward chance ≈ 1/8
    if the features are genuinely temporal)."""
    cfg = model.config
    device = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    batch = 16
    hits = {"direction": [], "kind": [], "event": []}
    moving_hits = []
    for start in range(0, n_clips, batch):
        n = min(batch, n_clips - start)
        clips, dirs, kinds, events = make_batch(rng, n, cfg.image_size, cfg.num_frames,
                                                (style,))
        if shuffle_frames:
            for ci in range(n):
                clips[ci] = clips[ci][rng.permutation(clips.shape[1])]
        _, d_log, k_log, e_log = model(_normalize(torch.from_numpy(clips).to(device)))
        d, k, e = (t.argmax(-1).cpu().numpy() for t in (d_log, k_log, e_log))
        hits["direction"] += list(d == dirs)
        hits["kind"] += list(k == kinds)
        hits["event"] += list(e == events)
        moving_hits += list((d == dirs)[dirs != 0])
    out = {f"{name}_acc": float(np.mean(v)) for name, v in hits.items()}
    out["direction_acc_moving"] = float(np.mean(moving_hits))
    out["n"] = n_clips
    return out


class TrainedClipEncoder:
    """Inference rung over the self-trained checkpoint: the interface of
    the hash fake (``encode_clip`` / ``encode_clips``) plus
    ``classify_clips``, the trained heads' softmax winners."""

    def __init__(self, model_cfg: VideoMAEConfig, model: ClipClassifier):
        self.config = model_cfg
        self.dim = model_cfg.hidden_size
        self.model = model
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def _run(self, batch: np.ndarray):
        emb, d_log, k_log, e_log = self.model(_normalize(torch.from_numpy(batch).to(self.device)))
        return (emb.float().cpu().numpy(),
                *(torch.softmax(t.float(), -1).cpu().numpy() for t in (d_log, k_log, e_log)))

    def _prepare(self, clip: np.ndarray) -> np.ndarray:
        from gvl_tpu_torch.runtime.native import resize_images

        cfg = self.config
        frames = list(resize_images(list(clip), cfg.image_size, cfg.image_size))
        while len(frames) < cfg.num_frames:  # short tail: repeat last
            frames.append(frames[-1])
        return np.stack(frames[:cfg.num_frames])

    def encode_clips(self, clips) -> np.ndarray:
        if not len(clips):
            return np.zeros((0, self.dim), np.float32)
        return self._run(np.stack([self._prepare(c) for c in clips]))[0]

    def encode_clip(self, clip: np.ndarray) -> np.ndarray:
        return self.encode_clips([clip])[0]

    def classify_clips(self, clips) -> list[dict]:
        """[{'direction': (name, p), 'kind': (name, p), 'event': (name, p)}]
        per clip."""
        if not len(clips):
            return []
        _, d_p, k_p, e_p = self._run(np.stack([self._prepare(c) for c in clips]))
        out = []
        for i in range(len(clips)):
            di, ki, ei = int(d_p[i].argmax()), int(k_p[i].argmax()), int(e_p[i].argmax())
            out.append({
                "direction": (DIRECTION_NAMES[di], float(d_p[i][di])),
                "kind": (CONCEPTS[ki], float(k_p[i][ki])),
                "event": (EVENTS[ei], float(e_p[i][ei])),
            })
        return out

    @classmethod
    def from_dir(cls, ckpt_dir, device: str | torch.device = "cuda") -> "TrainedClipEncoder":
        return cls(*load_clip_encoder(ckpt_dir, device))
