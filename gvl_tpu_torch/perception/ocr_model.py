"""Text detection and recognition: the OCR engine on the card (the port's
copy of the inference half of :mod:`gvl_tpu.perception.ocr_model`).

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
kernel).  Training stays in the JAX package.
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
