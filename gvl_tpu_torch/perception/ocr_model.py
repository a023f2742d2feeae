"""Text detection and recognition: the OCR engine on the card and its
trainers (counterpart of :mod:`gvl_tpu.perception.ocr_model`).

- **Detector** (DB-style): a conv net over a fixed gray canvas gives a
  1/4-resolution text-probability map; thresholded 4-connected components
  become boxes (union-find on the host).
- **Recognizer**: a conv column encoder over fixed-height crops, then
  (v2, the shipped checkpoint) two pre-norm self-attention blocks over the
  time axis, then per-step logits; CTC prefix-beam decode on the host.

Flax's ``nn.Conv`` pads "SAME": with a stride, more on the end than the
start, which torch's symmetric ``padding=`` cannot say, so every conv pads
with ``F.pad`` by Flax's rule (:func:`same_pads`).  The recognizer's
self-attention is plain PyTorch (in JAX it is Flax's, not the Pallas
kernel).

The trainers are the JAX module's on synthetic HUD text:
:func:`train_recognizer` (CTC, blank 0, the mean over the batch of each
crop's loss, Optax's ``adam``) on detector-style crops, and
:func:`train_detector` (class-balanced BCE) on pasted-text canvases; each
step is a function of its own (:func:`recognizer_loss`,
:func:`detector_loss`).  Rendering text needs Pillow, imported only inside
:func:`render_line` and :func:`discover_fonts` (the card's machine has
none: there the steps run on arrays of the trainers' shapes).
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.nn.layers import LayerNorm, gelu_tanh

logger = logging.getLogger(__name__)

DEFAULT_CHARSET = (
    "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "abcdefghijklmnopqrstuvwxyz :/-+.%"
)
BLANK_ID = 0  # CTC blank; charset ids are 1-based


@dataclass(frozen=True)
class OCRModelConfig:
    charset: str = DEFAULT_CHARSET
    det_height: int = 256
    det_width: int = 448
    det_stride: int = 4          # prob-map downscale
    rec_height: int = 32
    rec_width: int = 192
    rec_features: tuple[int, ...] = (32, 64, 128, 128)
    det_features: tuple[int, ...] = (16, 32, 32)
    det_threshold: float = 0.3  # matches reference det_db_thresh
    box_expand: int = 1          # prob-map px added per side (conv erosion)
    min_box_area: int = 12       # in prob-map pixels
    crop_buckets: tuple[int, ...] = (1, 2, 4, 8, 16)
    # "crnn" = the original 4-conv column net; "v2" = wider convs + a
    # 2-block transformer over the time axis (the capacity needed to hold
    # clean-HUD AND stylized-font accuracy in ONE checkpoint).  Engines
    # auto-detect the arch of a loaded checkpoint from its param tree.
    rec_arch: str = "crnn"
    v2_features: tuple[int, ...] = (64, 128, 256)
    v2_blocks: int = 2
    v2_heads: int = 4
    # CTC decode: beam width (1 = greedy; 3 recovers single-step
    # argmax flips at ~negligible host cost)
    beam_width: int = 3

    @property
    def num_classes(self) -> int:
        return len(self.charset) + 1   # + blank

    def encode(self, text: str) -> list[int]:
        return [self.charset.index(c) + 1 for c in text
                if c in self.charset]

    def decode_ids(self, ids: list[int]) -> str:
        return "".join(self.charset[i - 1] for i in ids if i > 0)


# --------------------------------------------------------------------------
# Networks (inputs channels-last ``[B, H, W, 1]``, as in the JAX package)
# --------------------------------------------------------------------------


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax's "SAME" padding of one axis: output ``ceil(size / stride)``,
    the total pad split with the extra element at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv(nn.Conv2d):
    """``nn.Conv2d`` with Flax's "SAME" padding, channels-first inside."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = same_pads(x.shape[2], kh, sh)
        left, right = same_pads(x.shape[3], kw, sw)
        return super().forward(F.pad(x, (left, right, top, bottom)))


def _conv(cin: int, cout: int, kernel: int = 3, stride=(1, 1)) -> SameConv:
    return SameConv(cin, cout, kernel, stride=stride)


def _column_height(config: OCRModelConfig) -> int:
    """The crop height after the recognizers' three stride-2 rows, which
    their last conv collapses to 1 with a stride of that height."""
    h = config.rec_height
    for _ in range(3):
        h = -(-h // 2)
    return h


class TextDetectorNet(nn.Module):
    """Gray canvas ``[B, H, W, 1]`` → text-probability logits ``[B, H/4, W/4]``."""

    def __init__(self, config: OCRModelConfig):
        super().__init__()
        f = config.det_features
        self.Conv_0 = _conv(1, f[0], stride=(2, 2))
        self.Conv_1 = _conv(f[0], f[1], stride=(2, 2))
        self.Conv_2 = _conv(f[1], f[2])
        self.Conv_3 = _conv(f[2], 1, kernel=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.relu(conv(x))
        return self.Conv_3(x)[:, 0]


class TextRecognizerNet(nn.Module):
    """Gray crop ``[B, 32, W, 1]`` → CTC logits ``[B, W/2, num_classes]``."""

    def __init__(self, config: OCRModelConfig):
        super().__init__()
        f = config.rec_features
        self.Conv_0 = _conv(1, f[0], stride=(2, 2))
        self.Conv_1 = _conv(f[0], f[1], stride=(2, 1))
        self.Conv_2 = _conv(f[1], f[2], stride=(2, 1))
        self.Conv_3 = _conv(f[2], f[3], stride=(_column_height(config), 1))
        self.Dense_0 = nn.Linear(f[3], config.num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.relu(conv(x))
        x = F.relu(self.Conv_3(x))[:, :, 0].transpose(1, 2)   # height 1: [B, T, F]
        return self.Dense_0(x)


class SelfAttention(nn.Module):
    """Flax's ``nn.SelfAttention`` (no mask): ``query/key/value/out`` with
    bias, the query scaled by 1/sqrt(head size) before the product, the
    softmax in f32."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.value, self.out = nn.Linear(dim, dim), nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        heads = lambda y: y.view(b, t, self.num_heads, -1).transpose(1, 2)
        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        q = q / float(np.sqrt(q.shape[-1]))
        weights = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        return self.out((weights @ v).transpose(1, 2).reshape(b, t, d))


class TextRecognizerNetV2(nn.Module):
    """Wider conv column, then two pre-norm self-attention blocks over the
    time axis: ``[B, 32, W, 1]`` → ``[B, W/2, num_classes]``."""

    def __init__(self, config: OCRModelConfig):
        super().__init__()
        f, d = config.v2_features, config.v2_features[2]
        self.blocks = config.v2_blocks
        self.Conv_0 = _conv(1, f[0], stride=(2, 2))
        self.Conv_1 = _conv(f[0], f[1], stride=(2, 1))
        self.Conv_2 = _conv(f[1], f[1])
        self.Conv_3 = _conv(f[1], f[2], stride=(2, 1))
        self.Conv_4 = _conv(f[2], f[2], stride=(_column_height(config), 1))
        self.pos_embed = nn.Parameter(torch.zeros(1, config.rec_width // 2, d))
        self.in_proj = nn.Linear(d, d)
        for i in range(config.v2_blocks):
            self.add_module(f"ln1_{i}", LayerNorm(d))
            self.add_module(f"attn_{i}", SelfAttention(d, config.v2_heads))
            self.add_module(f"ln2_{i}", LayerNorm(d))
            self.add_module(f"fc1_{i}", nn.Linear(d, 2 * d))
            self.add_module(f"fc2_{i}", nn.Linear(2 * d, d))
        self.ln_out = LayerNorm(d)
        self.Dense_0 = nn.Linear(d, config.num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2, self.Conv_3):
            x = F.relu(conv(x))
        x = F.relu(self.Conv_4(x))[:, :, 0].transpose(1, 2)   # height 1: [B, T, F]
        x = self.in_proj(x) + self.pos_embed
        for i in range(self.blocks):
            block = lambda name: getattr(self, f"{name}_{i}")
            x = x + block("attn")(block("ln1")(x))
            x = x + block("fc2")(gelu_tanh(block("fc1")(block("ln2")(x))))
        return self.Dense_0(self.ln_out(x))


def make_recognizer(config: OCRModelConfig) -> nn.Module:
    if config.rec_arch == "v2":
        return TextRecognizerNetV2(config)
    return TextRecognizerNet(config)


def detect_rec_arch(params: dict) -> str:
    """Checkpoint param tree → architecture name (v2 has attn blocks)."""
    rec = params.get("recognizer", params)
    tree = rec.get("params", rec)
    return "v2" if any("attn" in str(k) for k in tree) else "crnn"


# --------------------------------------------------------------------------
# Host-side post-processing
# --------------------------------------------------------------------------


def connected_components(mask: np.ndarray) -> list[tuple[int, int, int, int]]:
    """Boxes (x1, y1, x2, y2) of 4-connected True regions (union-find)."""
    h, w = mask.shape
    parent: dict[int, int] = {}

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    labels = np.zeros((h, w), np.int32)
    nxt = 1
    for y in range(h):
        for x in range(w):
            if not mask[y, x]:
                continue
            left = labels[y, x - 1] if x > 0 else 0
            up = labels[y - 1, x] if y > 0 else 0
            if left and up:
                labels[y, x] = left
                union(left, up)
            elif left or up:
                labels[y, x] = left or up
            else:
                labels[y, x] = nxt
                parent[nxt] = nxt
                nxt += 1
    boxes: dict[int, list[int]] = {}
    for y in range(h):
        for x in range(w):
            lab = labels[y, x]
            if not lab:
                continue
            root = find(lab)
            b = boxes.setdefault(root, [x, y, x, y])
            b[0], b[1] = min(b[0], x), min(b[1], y)
            b[2], b[3] = max(b[2], x), max(b[3], y)
    return [tuple(b) for b in boxes.values()]


def ctc_greedy_decode(
    logits: np.ndarray, config: OCRModelConfig
) -> tuple[str, float]:
    """Collapse repeats, drop blanks; confidence = mean best-prob."""
    ids = logits.argmax(-1)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    best = probs.max(-1)
    out, prev = [], -1
    for t, i in enumerate(ids):
        if i != prev and i != BLANK_ID:
            out.append(int(i))
        prev = int(i)
    text = config.decode_ids(out)
    return text, float(best.mean())


def ctc_beam_decode(
    logits: np.ndarray, config: OCRModelConfig, beam_width: int = 5
) -> tuple[str, float]:
    """CTC prefix beam search (host-side; the prob map is tiny).

    Sums path probabilities per prefix instead of taking the single best
    path — recovers labels the greedy argmax flips on one noisy step
    (the stylized-font failure mode).  ``beam_width=1`` falls back to
    greedy.
    """
    if beam_width <= 1:
        return ctc_greedy_decode(logits, config)
    lp = logits - logits.max(-1, keepdims=True)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))   # log-softmax
    T, C = lp.shape
    NEG = -1e30

    def logsum(a, b):
        m = max(a, b)
        if m <= NEG / 2:
            return NEG
        return m + np.log(np.exp(a - m) + np.exp(b - m))

    # prefix -> (logp ending in blank, logp ending in non-blank)
    beams = {(): (0.0, NEG)}
    for t in range(T):
        step = lp[t]
        # prune classes: only blank + top-k symbols matter
        top = np.argsort(-step)[: max(beam_width * 2, 8)]
        new: dict[tuple, list[float]] = {}

        def add(prefix, pb, pnb):
            if prefix in new:
                cur = new[prefix]
                new[prefix] = [logsum(cur[0], pb), logsum(cur[1], pnb)]
            else:
                new[prefix] = [pb, pnb]

        for prefix, (pb, pnb) in beams.items():
            total = logsum(pb, pnb)
            # blank extends, prefix unchanged
            add(prefix, total + step[BLANK_ID], NEG)
            last = prefix[-1] if prefix else None
            for c in top:
                c = int(c)
                if c == BLANK_ID:
                    continue
                pc = step[c]
                if c == last:
                    # repeat symbol: extends non-blank as same prefix,
                    # extends prefix only from the blank-ending mass
                    add(prefix, NEG, pnb + pc)
                    add(prefix + (c,), NEG, pb + pc)
                else:
                    add(prefix + (c,), NEG, total + pc)
        ranked = sorted(new.items(),
                        key=lambda kv: -logsum(kv[1][0], kv[1][1]))
        beams = {k: tuple(v) for k, v in ranked[:beam_width]}
    best_prefix, (pb, pnb) = max(
        beams.items(), key=lambda kv: logsum(kv[1][0], kv[1][1]))
    score = logsum(pb, pnb)
    text = config.decode_ids(list(best_prefix))
    return text, float(np.exp(score / max(T, 1)))


def ctc_decode(logits: np.ndarray, config: OCRModelConfig) -> tuple[str, float]:
    """Config-dispatching decode: beam when ``beam_width > 1``."""
    return ctc_beam_decode(logits, config, config.beam_width)


def _nn_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour resize (no PIL on the inference path)."""
    ys = (np.arange(h) * img.shape[0] / h).astype(np.int32)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.int32)
    return img[ys][:, xs]


def _to_gray(frame: np.ndarray) -> np.ndarray:
    if frame.ndim == 3:
        frame = frame[..., :3].astype(np.float32) @ np.asarray(
            [0.299, 0.587, 0.114], np.float32)
    return frame.astype(np.float32) / (255.0 if frame.max() > 1.5 else 1.0)


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------


class TorchOCREngine:
    """Callable OCR engine on ``device``: frame → ``[(text, confidence,
    bbox)]``.  ``params``: the JAX package's tree (``{"detector": ...,
    "recognizer": ...}``, numpy, as :func:`load_ocr_params` reads it);
    without it or a ``checkpoint``, random weights from ``generator``
    (seed 0 by default) and a warning."""

    def __init__(self, config: Optional[OCRModelConfig] = None,
                 params: Optional[dict] = None, checkpoint: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 device: str | torch.device = "cuda"):
        from gvl_tpu_torch.models.convert import ocr_net_params_from_jax
        from gvl_tpu_torch.nn.layers import init_state, load_module

        self.device = resolve_device(device)
        self.config = config or OCRModelConfig()
        if params is None and checkpoint is not None:
            params = load_ocr_params(checkpoint)
        # the checkpoint's recognizer architecture wins over the config
        # default (old CRNN checkpoints keep loading)
        if params is not None:
            arch = detect_rec_arch(params)
            if arch != self.config.rec_arch:
                self.config = dataclasses.replace(self.config, rec_arch=arch)
        else:
            logger.warning("TorchOCREngine with random weights: pass checkpoint=")
            generator = generator or torch.Generator(device=self.device).manual_seed(0)
        nets = {}
        for name, make in (("detector", TextDetectorNet), ("recognizer", make_recognizer)):
            with torch.device("meta"):
                net = make(self.config)
            state = (ocr_net_params_from_jax(params[name]) if params is not None
                     else init_state(net, generator, self.device))
            nets[name] = load_module(net, state, self.device)
        self.detector, self.recognizer = nets["detector"], nets["recognizer"]

    @torch.inference_mode()
    def _det(self, canvases: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(canvases, np.float32)).to(self.device)
        return torch.sigmoid(self.detector(x)).cpu().numpy()

    @torch.inference_mode()
    def _rec(self, crops: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(crops, np.float32)).to(self.device)
        return self.recognizer(x).cpu().numpy()

    def __call__(self, frame: np.ndarray) -> list[tuple[str, float, tuple]]:
        return self.batch([frame])[0]

    def batch(
        self, frames: list[np.ndarray]
    ) -> list[list[tuple[str, float, tuple]]]:
        """Many frames, few dispatches: ONE detector call on the stacked
        (bucket-padded) batch, then every crop across all frames through
        the recognizer in shared buckets."""
        cfg = self.config
        grays = [_to_gray(np.asarray(f)) for f in frames]
        canvases = np.stack([
            _nn_resize(g, cfg.det_height, cfg.det_width) for g in grays
        ])[..., None]
        n = len(frames)
        bucket_n = next((b for b in (1, 2, 4, 8, 16, 32) if n <= b), n)
        if bucket_n > n:
            canvases = np.concatenate(
                [canvases, np.zeros_like(canvases[:1]).repeat(
                    bucket_n - n, axis=0)])
        probs = self._det(canvases)[:n]

        all_crops: list[np.ndarray] = []
        all_boxes: list[tuple] = []
        owners: list[int] = []
        for fi, (gray, prob) in enumerate(zip(grays, probs)):
            crops, boxes = self._extract_crops(gray, prob)
            all_crops.extend(crops)
            all_boxes.extend(boxes)
            owners.extend([fi] * len(crops))

        results: list[list[tuple[str, float, tuple]]] = [[] for _ in frames]
        if not all_crops:
            return results
        step = cfg.crop_buckets[-1]
        for i in range(0, len(all_crops), step):
            chunk = all_crops[i:i + step]
            m = len(chunk)
            bucket = next((b for b in cfg.crop_buckets if m <= b),
                          cfg.crop_buckets[-1])
            batch = np.zeros(
                (bucket, cfg.rec_height, cfg.rec_width, 1), np.float32)
            batch[:m, :, :, 0] = np.stack(chunk)
            logits = self._rec(batch)
            for j in range(m):
                text, conf = ctc_decode(logits[j], cfg)
                if text:
                    results[owners[i + j]].append(
                        (text, conf, all_boxes[i + j]))
        return results

    def _extract_crops(self, gray: np.ndarray, prob: np.ndarray):
        """Host-side: prob map → expanded, ink-tightened recognizer crops."""
        cfg = self.config
        h0, w0 = gray.shape
        mask = prob > cfg.det_threshold
        boxes = [b for b in connected_components(mask)
                 if (b[2] - b[0] + 1) * (b[3] - b[1] + 1)
                 >= cfg.min_box_area]
        if not boxes:
            return [], []
        # map prob-map boxes back to original frame coordinates; expand
        # to recover glyph edges eroded by the conv receptive field
        mh, mw = mask.shape
        sy = h0 / mh
        sx = w0 / mw
        e = cfg.box_expand
        crops, out_boxes = [], []
        for x1, y1, x2, y2 in boxes:
            x1, y1 = max(x1 - e, 0), max(y1 - e, 0)
            x2, y2 = min(x2 + e, mw - 1), min(y2 + e, mh - 1)
            fx1, fy1 = int(x1 * sx), int(y1 * sy)
            fx2, fy2 = int((x2 + 1) * sx), int((y2 + 1) * sy)
            crop = gray[max(fy1, 0):fy2, max(fx1, 0):fx2]
            if crop.size == 0:
                continue
            # canonicalize: tighten to the ink inside the box (HUD text
            # is high-contrast) so the recognizer sees the same tight
            # crops it was trained on, whatever the detector's margins
            thresh = max(0.2, float(crop.mean() + 0.5 * crop.std()))
            ink_rows = np.nonzero(crop.max(1) > thresh)[0]
            ink_cols = np.nonzero(crop.max(0) > thresh)[0]
            if len(ink_rows) and len(ink_cols):
                m = 2
                crop = crop[max(ink_rows.min() - m, 0):
                            ink_rows.max() + 1 + m,
                            max(ink_cols.min() - m, 0):
                            ink_cols.max() + 1 + m]
            crops.append(crop_to_input(crop, cfg))
            out_boxes.append((float(fx1), float(fy1),
                              float(fx2), float(fy2)))
        # cap per frame at the largest recognizer bucket (same limit the
        # single-frame path always had)
        cap = cfg.crop_buckets[-1]
        return crops[:cap], out_boxes[:cap]


def load_ocr_params(path: str) -> dict:
    """The JAX package's OCR checkpoint (``detector/params/...``,
    ``recognizer/params/...``) as a nested dict of numpy arrays."""
    from gvl_tpu_torch.utils.checkpoints import load_flat_npz

    return load_flat_npz(path)


def crop_to_input(crop: np.ndarray, config: OCRModelConfig) -> np.ndarray:
    """The ONE crop→recognizer-input path (inference and training share it):
    scale height to ``rec_height`` preserving aspect, left-align, pad."""
    scale = config.rec_height / crop.shape[0]
    cw = max(min(int(crop.shape[1] * scale), config.rec_width), 1)
    resized = _nn_resize(crop, config.rec_height, cw)
    padded = np.zeros((config.rec_height, config.rec_width), np.float32)
    padded[:, :cw] = resized
    return padded


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _net_layout(net_fn, config: OCRModelConfig) -> dict:
    from gvl_tpu_torch.training.init_laws import named_net_layout

    with torch.device("meta"):
        return named_net_layout(net_fn(config), config.v2_heads)


def ocr_net_state(params: Optional[dict], net_fn, config: OCRModelConfig,
                  seed) -> dict[str, torch.Tensor]:
    """A net's weights: ``params`` (a state dict or the JAX variables) or,
    without it, drawn from ``seed`` (an int or a CPU generator) by Flax's
    laws."""
    from gvl_tpu_torch.models.convert import ocr_net_params_from_jax
    from gvl_tpu_torch.training import init_laws

    if params is not None:
        return init_laws.as_state(params, ocr_net_params_from_jax)
    return init_laws.init_params(ocr_net_params_from_jax, _net_layout(net_fn, config), seed)


def init_ocr_params(config: OCRModelConfig, seed: int = 0) -> dict:
    """Both nets drawn from one generator seeded ``seed``: ``{"detector":
    state, "recognizer": state}``."""
    generator = torch.Generator().manual_seed(seed)
    return {"detector": ocr_net_state(None, TextDetectorNet, config, generator),
            "recognizer": ocr_net_state(None, make_recognizer, config, generator)}


def save_ocr_params(states: dict, path: str, config: Optional[OCRModelConfig] = None) -> None:
    """The JAX package's OCR file (``detector/params/...``,
    ``recognizer/params/...``) of ``{"detector": state, "recognizer":
    state}``, nets of ``config``'s geometry (by default ``OCRModelConfig``
    with the recognizer's architecture)."""
    from gvl_tpu_torch.models.convert import ocr_net_params_from_jax, tree_from_state
    from gvl_tpu_torch.training.init_laws import shapes
    from gvl_tpu_torch.utils.checkpoints import save_flat_npz

    if config is None:
        arch = "v2" if any(k.startswith("attn_") for k in states["recognizer"]) else "crnn"
        config = OCRModelConfig(rec_arch=arch)
    save_flat_npz({name: tree_from_state(ocr_net_params_from_jax,
                                         shapes(_net_layout(net_fn, config)), states[name])
                   for name, net_fn in (("detector", TextDetectorNet),
                                        ("recognizer", make_recognizer))}, path)


# --------------------------------------------------------------------------
# Synthetic training data (Pillow-rendered HUD text)
# --------------------------------------------------------------------------

_HUD_TEMPLATES = (
    "HP {a}/{b}", "MP {a}/{b}", "LV {c}", "{a}", "{c}:{d}",
    "{a} gold", "+{c}", "-{c} HP",
    # rare glyphs get extra weight ('%' is otherwise under-learned)
    "{c}%", "{c}%", "{a}%",
)

_HUD_WORDS = (
    "SCORE", "AMMO", "GOLD", "LEVEL", "WAVE", "COMBO", "XP", "KILLS",
    "PING", "FPS", "TIME", "BONUS", "ARMOR", "ENERGY", "SHIELD", "COINS",
    "STAGE", "LIVES", "MANA", "RAGE", "EXP", "DMG", "CRIT", "SPD",
)


def synth_text(rng: np.random.Generator, charset: str, open_vocab: bool = True) -> str:
    """HUD-style strings with open vocabulary: numeric templates,
    word+number labels and random charset strings (``open_vocab=False``:
    the numeric templates only)."""
    r = rng.random() if open_vocab else 0.0
    if r < 0.35:
        tpl = _HUD_TEMPLATES[rng.integers(0, len(_HUD_TEMPLATES))]
        text = tpl.format(a=rng.integers(1, 999), b=rng.integers(1, 999),
                          c=rng.integers(0, 99), d=f"{rng.integers(0, 59):02d}")
    elif r < 0.70:
        word = _HUD_WORDS[rng.integers(0, len(_HUD_WORDS))]
        if rng.random() < 0.3:
            word = word.capitalize() if rng.random() < 0.5 else word.lower()
        form = rng.random()
        if form < 0.4:
            text = f"{word} {rng.integers(0, 9999)}"
        elif form < 0.6:
            text = f"{word} {rng.integers(1, 999)}/{rng.integers(1, 999)}"
        elif form < 0.8:
            text = f"{word} x{rng.integers(2, 99)}"
        else:
            text = word
    else:
        # open-vocabulary: random charset strings (no leading/trailing
        # spaces, at most one space run)
        glyphs = charset.replace(" ", "")
        n = int(rng.integers(3, 13))
        chars = [glyphs[int(rng.integers(0, len(glyphs)))] for _ in range(n)]
        if n >= 5 and rng.random() < 0.5:
            chars[int(rng.integers(1, n - 1))] = " "
        text = "".join(chars).strip()
    return "".join(c for c in text if c in charset) or "0"


_FONT_POOL: Optional[list] = None


def discover_fonts() -> list[str]:
    """Usable TTF text fonts on this system (matplotlib ships DejaVu even
    when no system fonts exist); symbol fonts are filtered by rendering
    digits.  Needs Pillow."""
    global _FONT_POOL
    if _FONT_POOL is not None:
        return _FONT_POOL
    import glob

    from PIL import Image, ImageDraw, ImageFont

    candidates: list[str] = glob.glob("/usr/share/fonts/**/*.ttf", recursive=True)
    try:
        import matplotlib

        candidates += glob.glob(matplotlib.get_data_path() + "/fonts/ttf/*.ttf")
    except ImportError:
        pass
    pool = []
    for path in sorted(set(candidates)):
        try:
            font = ImageFont.truetype(path, 16)
            probe = Image.new("L", (64, 24), 0)
            ImageDraw.Draw(probe).text((2, 2), "0A/:", fill=255, font=font)
            if np.asarray(probe).max() > 128:   # renders real glyphs
                pool.append(path)
        except Exception:
            continue
    _FONT_POOL = pool
    logger.info("OCR training font pool: %d TTF fonts", len(pool))
    return pool


def render_line(text: str, height: int, width: int, font_size: int = 16,
                font_path: Optional[str] = None) -> np.ndarray:
    """Rendered gray line in [0, 1], left-aligned, zero-padded (Pillow)."""
    from PIL import Image, ImageDraw, ImageFont

    img = Image.new("L", (width, height), 0)
    draw = ImageDraw.Draw(img)
    if font_path:
        font = ImageFont.truetype(font_path, font_size)
    else:
        try:
            font = ImageFont.load_default(size=font_size)
        except TypeError:      # older PIL: fixed-size bitmap font
            font = ImageFont.load_default()
    draw.text((2, max((height - font_size) // 2 - 2, 0)), text, fill=255, font=font)
    return np.asarray(img, np.float32) / 255.0


def _photometric(crop: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Ink gain, background lift, pixel noise."""
    gain = float(rng.uniform(0.6, 1.0))
    bg = float(rng.uniform(0.0, 0.2))
    return np.clip(crop * gain + bg + rng.normal(0, 0.02, crop.shape), 0.0, 1.0)


def _synth_crop(text: str, config: OCRModelConfig, rng: np.random.Generator,
                use_fonts: bool = False, photometric: Optional[bool] = None) -> np.ndarray:
    """A training sample that mimics a detector crop: rendered at a random
    size (in a random font with ``use_fonts``), tight-cropped around the ink
    with a random margin, jittered, then the shared resize path."""
    font_size = int(rng.integers(12, 24))
    font_path = None
    if use_fonts:
        pool = discover_fonts()
        # keep a solid share of default-font samples
        if pool and rng.random() < 0.6:
            font_path = pool[int(rng.integers(0, len(pool)))]
    line = render_line(text, font_size + 16, min(font_size * len(text) + 16, 512), font_size,
                       font_path=font_path)
    rows = np.nonzero(line.max(1) > 0.2)[0]
    cols = np.nonzero(line.max(0) > 0.2)[0]
    if len(rows) == 0 or len(cols) == 0:
        return np.zeros((config.rec_height, config.rec_width), np.float32)
    my1, my2 = int(rng.integers(0, 4)), int(rng.integers(0, 4))
    mx1, mx2 = int(rng.integers(0, 4)), int(rng.integers(0, 4))
    crop = line[max(rows.min() - my1, 0):rows.max() + 1 + my2,
                max(cols.min() - mx1, 0):cols.max() + 1 + mx2]
    if photometric is None:
        photometric = use_fonts
    if photometric:
        crop = _photometric(crop, rng)
    return crop_to_input(crop.astype(np.float32), config)


def _synth_negative_crop(config: OCRModelConfig, rng: np.random.Generator) -> np.ndarray:
    """A non-text crop (entity blob / edge / noise) whose CTC target is
    empty."""
    h = int(rng.integers(16, 40))
    w = int(rng.integers(16, 140))
    img = np.zeros((h, w), np.float32)
    kind = rng.random()
    if kind < 0.4:        # solid bright rectangle (HUD bar / entity)
        img[:] = float(rng.uniform(0.3, 1.0))
    elif kind < 0.7:      # ellipse on dark background
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx = h // 2, w // 2
        hit = (((xx - cx) / max(w // 2, 1)) ** 2 + ((yy - cy) / max(h // 2, 1)) ** 2) <= 1.0
        img[hit] = float(rng.uniform(0.4, 1.0))
    else:                 # structured noise
        img = rng.uniform(0, rng.uniform(0.3, 0.8), (h, w)).astype(np.float32)
    return crop_to_input(img, config)


def render_frame(texts: list[str], config: OCRModelConfig, rng: np.random.Generator,
                 font_size: Optional[int] = None, distractors: bool = False,
                 use_fonts: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """A canvas with text lines pasted at random spots + the 1/4-resolution
    target mask; ``distractors`` adds a lifted noisy background and bright
    entity-sized blobs the detector must ignore."""
    h, w, s = config.det_height, config.det_width, config.det_stride
    canvas = np.zeros((h, w), np.float32)
    target = np.zeros((h // s, w // s), np.float32)
    if distractors:
        canvas += float(rng.uniform(0.0, 0.3))
        canvas += rng.normal(0, rng.uniform(0.005, 0.04), canvas.shape)
        yy, xx = np.mgrid[0:h, 0:w]
        for _ in range(int(rng.integers(0, 5))):
            bh = int(rng.integers(12, 90))
            bw = int(rng.integers(12, 90))
            cy = int(rng.integers(0, h))
            cx = int(rng.integers(0, w))
            val = float(rng.uniform(0.3, 0.95))
            if rng.random() < 0.5:   # ellipse
                hit = (((xx - cx) / max(bw, 1)) ** 2 + ((yy - cy) / max(bh, 1)) ** 2) <= 1.0
            else:                    # rectangle
                hit = (np.abs(xx - cx) <= bw // 2) & (np.abs(yy - cy) <= bh // 2)
            canvas[hit] = val
        canvas = np.clip(canvas, 0.0, 1.0)
    font_pool = discover_fonts() if use_fonts else []
    for text in texts:
        fs = font_size or int(rng.integers(12, 24))
        lh = fs + 16
        lw = min(fs * len(text) + 8, w // 2)
        font_path = None
        if font_pool and rng.random() < 0.4:
            font_path = font_pool[int(rng.integers(0, len(font_pool)))]
        line = render_line(text, lh, lw, fs, font_path=font_path)
        y = int(rng.integers(0, h - lh))
        x = int(rng.integers(0, w - lw))
        canvas[y:y + lh, x:x + lw] = np.maximum(canvas[y:y + lh, x:x + lw], line)
        cols = line.max(0) > 0.2
        if cols.any():
            tx2 = x + int(np.nonzero(cols)[0].max()) + 1
            rows = line.max(1) > 0.2
            ty1 = y + int(np.nonzero(rows)[0].min())
            ty2 = y + int(np.nonzero(rows)[0].max()) + 1
            target[ty1 // s:max(ty2 // s, ty1 // s + 1),
                   x // s:max(tx2 // s, x // s + 1)] = 1.0
    # dilate 1 px so the trained map covers full glyph extents
    th, tw = target.shape
    padded = np.pad(target, 1)
    target = np.max(np.stack([padded[1 + dy:1 + dy + th, 1 + dx:1 + dx + tw]
                              for dy in (-1, 0, 1) for dx in (-1, 0, 1)]), axis=0)
    return canvas, target


# --------------------------------------------------------------------------
# Training steps and trainers
# --------------------------------------------------------------------------

def recognizer_loss(net: nn.Module, images: torch.Tensor, labels: torch.Tensor,
                    label_pad: torch.Tensor) -> torch.Tensor:
    """CTC (blank 0) of each crop over every time step, averaged over the
    batch (as the JAX trainer takes the mean of Optax's CTC): ``label_pad`` is 1 past each
    label's end."""
    logits = net(images)                                  # [B, T, C]
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    batch, steps = logits.shape[:2]
    target_lengths = (1.0 - label_pad).sum(-1).round().long()
    input_lengths = torch.full((batch,), steps, dtype=torch.long, device=logits.device)
    return F.ctc_loss(log_probs, labels.long(), input_lengths, target_lengths,
                      blank=BLANK_ID, reduction="none").mean()


def detector_loss(net: nn.Module, images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Class-balanced BCE (text pixels weigh 5) of the probability map."""
    logits = net(images)
    bce = -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)
    return (bce * torch.where(targets > 0.5, 5.0, 1.0)).mean()


def train_recognizer(config: OCRModelConfig, steps: int = 600, batch_size: int = 32,
                     learning_rate: float = 1e-3, seed: int = 0,
                     params: Optional[dict] = None, max_label_len: int = 16,
                     log_every: int = 0, use_fonts: bool = False, pool_size: int = 0,
                     open_vocab: bool = True, negative_frac: float = 0.07,
                     device="cuda", on_step=None) -> dict[str, torch.Tensor]:
    """CTC-train the recognizer on synthetic detector-style crops and return
    its f32 state dict (JAX's ``train_recognizer``: ``params`` warm-starts
    it; ``pool_size`` pre-renders that many crops and draws each batch from
    them with fresh photometric jitter; ``on_step(i, loss)`` sees each
    step's loss on the device)."""
    from gvl_tpu_torch.training import init_laws, optim

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        net = make_recognizer(config)
    net = init_laws.trainable(net, ocr_net_state(params, make_recognizer, config, seed), dev)
    opt = optim.AdamW(net.parameters(), learning_rate, clip=None, weight_decay=0.0)
    pool = None
    if pool_size:
        pool_images = np.zeros((pool_size, config.rec_height, config.rec_width), np.float32)
        pool_labels = np.zeros((pool_size, max_label_len), np.int32)
        pool_pad = np.ones((pool_size, max_label_len), np.float32)
        for i in range(pool_size):
            if rng.random() < negative_frac:  # non-text → empty target
                pool_images[i] = _synth_negative_crop(config, rng)
                continue
            text = synth_text(rng, config.charset, open_vocab=open_vocab)[:max_label_len] or "0"
            # geometry only: photometrics are re-rolled per step
            pool_images[i] = _synth_crop(text, config, rng, use_fonts=use_fonts,
                                         photometric=False)
            ids = config.encode(text)
            pool_labels[i, :len(ids)] = ids
            pool_pad[i, :len(ids)] = 0.0
        pool = (pool_images, pool_labels, pool_pad)
        logger.info("rec sample pool: %d crops rendered", pool_size)
    for i in range(steps):
        if pool is not None:
            idx = rng.integers(0, pool_size, batch_size)
            raw = pool[0][idx]
            if use_fonts:   # per-step photometric jitter
                gain = rng.uniform(0.6, 1.0, (batch_size, 1, 1))
                bg = rng.uniform(0.0, 0.2, (batch_size, 1, 1))
                raw = np.clip(raw * gain + bg + rng.normal(0, 0.02, raw.shape), 0.0, 1.0)
            images = raw[..., None].astype(np.float32)
            labels, label_pad = pool[1][idx], pool[2][idx]
        else:
            images = np.zeros((batch_size, config.rec_height, config.rec_width, 1), np.float32)
            labels = np.zeros((batch_size, max_label_len), np.int32)
            label_pad = np.ones((batch_size, max_label_len), np.float32)
            for b in range(batch_size):
                if rng.random() < negative_frac:
                    images[b, :, :, 0] = _synth_negative_crop(config, rng)
                    continue
                text = synth_text(rng, config.charset, open_vocab=open_vocab)[:max_label_len] \
                    or "0"
                images[b, :, :, 0] = _synth_crop(text, config, rng, use_fonts=use_fonts)
                ids = config.encode(text)
                labels[b, :len(ids)] = ids
                label_pad[b, :len(ids)] = 0.0
        batch = [torch.from_numpy(a).to(dev) for a in (images, labels, label_pad)]
        loss = optim.train_step(net, opt, lambda m: recognizer_loss(m, *batch))
        if on_step is not None:
            on_step(i, loss)
        if log_every and (i + 1) % log_every == 0:
            logger.info("rec step %d loss %.4f", i + 1, float(loss))
    return init_laws.state_of(net)


def train_detector(config: OCRModelConfig, steps: int = 300, batch_size: int = 8,
                   learning_rate: float = 1e-3, seed: int = 0, params: Optional[dict] = None,
                   log_every: int = 0, distractors: bool = False, use_fonts: bool = False,
                   device="cuda", on_step=None) -> dict[str, torch.Tensor]:
    """BCE-train the detector on synthetic pasted-text canvases and return
    its f32 state dict (JAX's ``train_detector``)."""
    from gvl_tpu_torch.training import init_laws, optim

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        net = TextDetectorNet(config)
    net = init_laws.trainable(net, ocr_net_state(params, TextDetectorNet, config, seed), dev)
    opt = optim.AdamW(net.parameters(), learning_rate, clip=None, weight_decay=0.0)
    for i in range(steps):
        images = np.zeros((batch_size, config.det_height, config.det_width, 1), np.float32)
        targets = np.zeros((batch_size, config.det_height // config.det_stride,
                            config.det_width // config.det_stride), np.float32)
        for b in range(batch_size):
            texts = [synth_text(rng, config.charset) for _ in range(int(rng.integers(1, 4)))]
            images[b, :, :, 0], targets[b] = render_frame(
                texts, config, rng, distractors=distractors and bool(rng.random() < 0.8),
                use_fonts=use_fonts)
        batch = [torch.from_numpy(a).to(dev) for a in (images, targets)]
        loss = optim.train_step(net, opt, lambda m: detector_loss(m, *batch))
        if on_step is not None:
            on_step(i, loss)
        if log_every and (i + 1) % log_every == 0:
            logger.info("det step %d loss %.4f", i + 1, float(loss))
    return init_laws.state_of(net)


@torch.inference_mode()
def evaluate_recognizer(params: dict, config: Optional[OCRModelConfig] = None, n: int = 200,
                        seed: int = 4321, use_fonts: bool = True, device="cuda") -> dict:
    """Held-out exact-match accuracy on synthetic detector-style crops
    (multi-font when ``use_fonts``; ``params``: a state dict or the JAX
    variables)."""
    from gvl_tpu_torch.nn.layers import load_module

    config = config or OCRModelConfig()
    dev = resolve_device(device)
    with torch.device("meta"):
        net = make_recognizer(config)
    net = load_module(net, ocr_net_state(params, make_recognizer, config, 0), dev)
    rng = np.random.default_rng(seed)
    correct = total = 0
    batch = 32
    while total < n:
        m = min(batch, n - total)
        images = np.zeros((batch, config.rec_height, config.rec_width, 1), np.float32)
        texts = []
        for b in range(m):
            text = synth_text(rng, config.charset)[:16] or "0"
            texts.append(text)
            images[b, :, :, 0] = _synth_crop(text, config, rng, use_fonts=use_fonts)
        logits = net(torch.from_numpy(images).to(dev)).float().cpu().numpy()
        for b in range(m):
            pred, _ = ctc_decode(logits[b], config)
            correct += int(pred == texts[b])
        total += m
    return {"exact_match": correct / total, "n": total,
            "fonts": len(discover_fonts()) if use_fonts else 0}
