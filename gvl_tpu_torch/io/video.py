"""Video frame sources without external codec dependencies (the port's
copy of :mod:`gvl_tpu.io.video`).

- :class:`Y4MReader`: streaming parser for uncompressed YUV4MPEG2, with
  4:2:0 / 4:2:2 / 4:4:4 -> RGB conversion in vectorized numpy (float);
- :class:`SyntheticVideo`: procedural gameplay-like clips
  (``synthetic://boss_fight?duration=30&fps=2``) with moving entities, a
  HUD and an optional procedural soundtrack with known ground truth;
- cv2 when it is installed.

``extract_frames(path, fps)`` keeps the ``[(timestamp, frame)]`` contract.
A ``.y4m`` file is decoded as the JAX package decodes it when its native
runtime is built: by the port's native decoder behind its prefetch ring
(:class:`gvl_tpu_torch.runtime.native.NativePrefetchSource`), whose
fixed-point arithmetic :class:`gvl_tpu_torch.runtime.y4m.Y4MFrameSource`
copies in numpy.
"""

from __future__ import annotations

import logging
import urllib.parse
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------- y4m

class Y4MReader:
    """Streaming YUV4MPEG2 reader."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        header = self._file.readline().decode("ascii", "ignore").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"not a y4m file: {self.path}")
        self.width = self.height = 0
        self.fps = 30.0
        self.colorspace = "420"
        for token in header.split()[1:]:
            if token[0] == "W":
                self.width = int(token[1:])
            elif token[0] == "H":
                self.height = int(token[1:])
            elif token[0] == "F":
                num, den = token[1:].split(":")
                self.fps = int(num) / int(den)
            elif token[0] == "C":
                self.colorspace = token[1:]
        if not (self.width and self.height):
            raise ValueError(f"y4m header missing dimensions: {header!r}")
        self._frame_bytes = self._compute_frame_bytes()

    def _compute_frame_bytes(self) -> int:
        w, h = self.width, self.height
        if self.colorspace.startswith("420"):
            return w * h + 2 * (w // 2) * (h // 2)
        if self.colorspace.startswith("422"):
            return w * h + 2 * (w // 2) * h
        if self.colorspace.startswith("444"):
            return 3 * w * h
        raise ValueError(f"unsupported y4m colorspace: {self.colorspace}")

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            line = self._file.readline()
            if not line:
                return
            if not line.startswith(b"FRAME"):
                return
            raw = self._file.read(self._frame_bytes)
            if len(raw) < self._frame_bytes:
                return
            yield self._to_rgb(np.frombuffer(raw, np.uint8))

    def _to_rgb(self, buf: np.ndarray) -> np.ndarray:
        w, h = self.width, self.height
        y = buf[: w * h].reshape(h, w).astype(np.float32)
        if self.colorspace.startswith("420"):
            cw, ch = w // 2, h // 2
            u = buf[w * h: w * h + cw * ch].reshape(ch, cw)
            v = buf[w * h + cw * ch:].reshape(ch, cw)
            u = np.repeat(np.repeat(u, 2, 0), 2, 1)[:h, :w].astype(np.float32)
            v = np.repeat(np.repeat(v, 2, 0), 2, 1)[:h, :w].astype(np.float32)
        elif self.colorspace.startswith("422"):
            cw = w // 2
            u = buf[w * h: w * h + cw * h].reshape(h, cw)
            v = buf[w * h + cw * h:].reshape(h, cw)
            u = np.repeat(u, 2, 1)[:, :w].astype(np.float32)
            v = np.repeat(v, 2, 1)[:, :w].astype(np.float32)
        else:  # 444
            u = buf[w * h: 2 * w * h].reshape(h, w).astype(np.float32)
            v = buf[2 * w * h:].reshape(h, w).astype(np.float32)
        # BT.601 limited-range YUV -> RGB (matches the native decoder)
        y = 1.164 * (y - 16.0)
        u -= 128.0
        v -= 128.0
        r = y + 1.596 * v
        g = y - 0.392 * u - 0.813 * v
        b = y + 2.017 * u
        rgb = np.stack([r, g, b], axis=-1)
        return np.clip(rgb, 0, 255).astype(np.uint8)

    def close(self) -> None:
        self._file.close()


def write_y4m(path: str | Path, frames: list[np.ndarray], fps: float) -> None:
    """Write RGB frames as 4:2:0 y4m (testing/interchange utility)."""
    h, w = frames[0].shape[:2]
    num = int(round(fps * 1000))
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{num}:1000 Ip A1:1 C420jpeg\n".encode())
        for frame in frames:
            rgb = frame.astype(np.float32)
            r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
            y = 16.0 + (0.257 * r + 0.504 * g + 0.098 * b)
            u = 128.0 + (-0.148 * r - 0.291 * g + 0.439 * b)
            v = 128.0 + (0.439 * r - 0.368 * g - 0.071 * b)
            y = np.clip(y, 0, 255).astype(np.uint8)
            u = np.clip(u[::2, ::2], 0, 255).astype(np.uint8)
            v = np.clip(v[::2, ::2], 0, 255).astype(np.uint8)
            f.write(b"FRAME\n")
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())


# --------------------------------------------------------------- synthetic

# Bump whenever the deterministic synthetic renderer or soundtrack scheme
# changes (e.g. the audio-seed derivation in ``_audio_seed``): it is mixed
# into the feature-cache content hash for ``synthetic://`` URLs, so stale
# cache entries carrying old-scheme transcripts can never silently
# mismatch recomputed ground truth (ADVICE r3).
SYNTHETIC_SCHEME_VERSION = 2


class SyntheticVideo:
    """Procedural gameplay-like clip: moving entities + HUD bar.

    Deterministic per (scene, frame index), so caches and tests are
    reproducible.  URL form: ``synthetic://<scene>?duration=30&fps=2``.
    """

    def __init__(self, scene: str = "boss_fight", duration: float = 10.0,
                 fps: float = 30.0, width: int = 320, height: int = 240,
                 entities: Optional[list[str]] = None,
                 hud_text: Optional[str] = None,
                 with_audio: bool = False):
        self.scene = scene
        self.duration = duration
        self.fps = fps
        self.width = width
        self.height = height
        # concept_demo scenes: which CONCEPT_SPECS entities to draw
        # (None = all) — the grounding channel for synthetic QA samples
        self.entities = entities
        # optional white HUD text rendered each frame (OCR grounding)
        self.hud_text = hud_text
        # ``?audio=1``: procedural soundtrack with known ground truth
        self.with_audio = with_audio
        seed = int.from_bytes(scene.encode()[:8].ljust(8, b"\0"), "little")
        rng = np.random.default_rng(seed)
        self._bg = rng.integers(20, 80, (height, width, 3)).astype(np.uint8)
        self._entity_colors = rng.integers(100, 255, (3, 3)).astype(np.uint8)

    @classmethod
    def from_url(cls, url: str) -> "SyntheticVideo":
        parsed = urllib.parse.urlparse(url)
        query = urllib.parse.parse_qs(parsed.query)
        get = lambda key, default: float(query.get(key, [default])[0])
        entities = None
        if "entities" in query:
            entities = [e for e in query["entities"][0].split(",") if e]
        hud_text = query.get("text", [None])[0]
        return cls(
            scene=parsed.netloc or "boss_fight",
            duration=get("duration", 10.0),
            fps=get("fps", 30.0),
            width=int(get("width", 320)),
            height=int(get("height", 240)),
            entities=entities,
            hud_text=hud_text,
            with_audio=bool(int(get("audio", 0))),
        )

    @property
    def num_frames(self) -> int:
        return int(self.duration * self.fps)

    @property
    def _CONCEPT_SPECS(self):
        # single source of truth: the signatures the shipped segmenter
        # checkpoint was trained on (drift here would silently break the
        # concept_demo end-to-end path)
        from gvl_tpu_torch.training.segmenter_train import CONCEPT_SPECS

        return CONCEPT_SPECS

    def _concept_frame(self, index: int) -> np.ndarray:
        """`concept_demo` scene: entities drawn with the signatures the
        shipped segmenter checkpoint was trained on, so text prompts
        ("enemy", "boss", …) ground to real masks end-to-end."""
        h, w = self.height, self.width
        img = self._bg.copy()
        t = index / max(self.fps, 1e-6)
        yy, xx = np.mgrid[0:h, 0:w]
        for e, (name, (kind, color)) in enumerate(
                self._CONCEPT_SPECS.items()):
            if self.entities is not None and name not in self.entities:
                continue
            phase = t * (0.3 + 0.15 * e) + e * 1.7
            cx = int((0.5 + 0.33 * np.sin(phase)) * w)
            cy = int((0.5 + 0.28 * np.cos(phase * 0.8)) * h)
            r = (16, 14, 30, 10)[e]
            if kind == "square":
                hit = (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r)
            elif kind == "triangle":
                hit = ((yy >= cy - r) & (yy <= cy + r)
                       & (np.abs(xx - cx) <= (yy - (cy - r)) / 2))
            elif kind == "ellipse":
                hit = (((xx - cx) / r) ** 2
                       + ((yy - cy) / (r * 0.7)) ** 2) <= 1.0
            else:
                hit = (np.abs(xx - cx) + np.abs(yy - cy)) <= r
            img[hit] = color
        hp = max(0.05, 1.0 - t / max(self.duration, 1e-6))
        img[8:16, 8: 8 + int(100 * hp)] = (200, 40, 40)
        img[8:16, 8 + int(100 * hp): 108] = (60, 60, 60)
        return img

    def _with_hud_text(self, img: np.ndarray) -> np.ndarray:
        """Render ``hud_text`` in white (PIL default font) top-right —
        the regime the shipped OCR checkpoint is trained on."""
        if not self.hud_text:
            return img
        from PIL import Image, ImageDraw, ImageFont

        try:
            font = ImageFont.load_default(size=16)
        except TypeError:          # older PIL: fixed-size bitmap font
            font = ImageFont.load_default()
        pil = Image.fromarray(img)
        x = max(int(self.width * 0.55), 0)
        ImageDraw.Draw(pil).text((x, 26), self.hud_text,
                                 fill=(255, 255, 255), font=font)
        return np.asarray(pil)

    def frame(self, index: int) -> np.ndarray:
        if self.scene.startswith("concept_demo"):
            return self._with_hud_text(self._concept_frame(index))
        h, w = self.height, self.width
        img = self._bg.copy()
        t = index / max(self.fps, 1e-6)
        for e in range(3):
            phase = t * (0.3 + 0.2 * e) + e * 2.1
            cx = int((0.5 + 0.35 * np.sin(phase)) * w)
            cy = int((0.5 + 0.3 * np.cos(phase * 0.7)) * h)
            size = 12 + 6 * e
            x1, x2 = max(0, cx - size), min(w, cx + size)
            y1, y2 = max(0, cy - size), min(h, cy + size)
            img[y1:y2, x1:x2] = self._entity_colors[e]
        # HUD: health bar shrinking over time
        hp = max(0.05, 1.0 - t / max(self.duration, 1e-6))
        img[8:16, 8: 8 + int(100 * hp)] = (200, 40, 40)
        img[8:16, 8 + int(100 * hp): 108] = (60, 60, 60)
        return self._with_hud_text(img)

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(self.num_frames):
            yield self.frame(i)

    # ------------------------------------------------------------- audio
    # Procedural soundtrack with KNOWN ground truth, so the audio stack
    # (trained event classifier + trained byte ASR + chunk embedder) is
    # exercisable end-to-end on synthetic clips — previously they were
    # silent and audio capability was untestable through process_video.
    # Opt-in via ``synthetic://scene?audio=1`` (existing fixtures keep
    # their silent behavior).

    SPEECH_LINES = ("enemy ahead take cover", "press the button now",
                    "grab the key and run", "the bridge is out")

    def _audio_seed(self) -> int:
        """Full-name hash: scene names sharing a first-8-byte prefix
        (every ``concept_demo_*``) must NOT share a soundtrack, or the
        audio-grounded QA family degenerates to one constant answer."""
        import hashlib

        digest = hashlib.blake2b(self.scene.encode(),
                                 digest_size=8).digest()
        return int.from_bytes(digest, "little") ^ 0xA0D10

    def audio_ground_truth(self) -> list[tuple[float, str, str]]:
        """[(t_seconds, kind, payload)] — kinds: speech/impact/ui."""
        rng = np.random.default_rng(self._audio_seed())
        truth = []
        if self.duration >= 6.0:
            text = str(self.SPEECH_LINES[
                int(rng.integers(0, len(self.SPEECH_LINES)))])
            truth.append((0.5, "speech", text))
        if self.duration >= 3.0:
            truth.append((round(self.duration * 0.55, 2), "impact", ""))
        if self.duration >= 4.0:
            truth.append((round(self.duration * 0.8, 2), "ui", ""))
        return truth

    def audio(self, sample_rate: int = 16000) -> tuple[np.ndarray, int]:
        """Deterministic f32 track for the clip ([duration*sr], sr)."""
        n = int(self.duration * sample_rate)
        out = np.zeros(n, np.float32)
        for t, kind, payload in self.audio_ground_truth():
            start = int(t * sample_rate)
            if kind == "speech":
                from gvl_tpu_torch.training.asr_train import (
                    SpeakerProfile,
                    synth_speech,
                )

                # fixed mid-range profile: inside every trained range,
                # so the shipped ASR's transcript is dependable
                profile = SpeakerProfile(f0=140.0, formant_scale=1.0,
                                         char_dur=0.075, noise_db=-28.0)
                wav = synth_speech(np.random.default_rng(7), payload,
                                   profile=profile, total_seconds=4.0)
            else:
                from gvl_tpu_torch.audio.event_model import (
                    EventModelConfig,
                    synth_event,
                )

                wav = synth_event(np.random.default_rng(11 if kind ==
                                                        "impact" else 13),
                                  kind, EventModelConfig())
            end = min(n, start + len(wav))
            if end > start:
                out[start:end] += np.asarray(wav[: end - start],
                                             np.float32)
        return np.clip(out, -1.0, 1.0), sample_rate


# -------------------------------------------------------------- dispatcher

def probe_video(path: str) -> dict:
    """Duration/fps/size metadata without decoding all frames."""
    if path.startswith("synthetic://"):
        synth = SyntheticVideo.from_url(path)
        return {"fps": synth.fps, "duration": synth.duration,
                "width": synth.width, "height": synth.height,
                "source": "synthetic"}
    p = Path(path)
    if p.suffix.lower() == ".y4m":
        reader = Y4MReader(p)
        n = sum(1 for _ in reader)
        reader.close()
        return {"fps": reader.fps, "duration": n / reader.fps,
                "width": reader.width, "height": reader.height,
                "source": "y4m"}
    try:
        import cv2

        cap = cv2.VideoCapture(str(p))
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        n = cap.get(cv2.CAP_PROP_FRAME_COUNT)
        meta = {"fps": fps, "duration": n / fps,
                "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                "source": "cv2"}
        cap.release()
        return meta
    except ImportError as exc:
        raise RuntimeError(
            f"cannot decode {path}: no y4m/synthetic source and cv2 is "
            f"not installed"
        ) from exc


def extract_frames(
    video_path: str,
    fps: float = 1.0,
    max_frames: Optional[int] = None,
) -> list[tuple[float, np.ndarray]]:
    """Decode + subsample to ``[(timestamp_sec, rgb_frame)]``.

    Accepts ``synthetic://`` URLs, ``.y4m`` files, or anything cv2 can
    open when available.
    """
    out: list[tuple[float, np.ndarray]] = []

    if video_path.startswith("synthetic://"):
        synth = SyntheticVideo.from_url(video_path)
        step = max(1, int(round(synth.fps / fps)))
        for i in range(0, synth.num_frames, step):
            out.append((i / synth.fps, synth.frame(i)))
            if max_frames and len(out) >= max_frames:
                break
        return out

    path = Path(video_path)
    if path.suffix.lower() == ".y4m":
        # the native decoder behind its prefetch ring (decode overlaps the
        # consumer), as the JAX package takes it when its runtime is built
        from gvl_tpu_torch.runtime.native import NativePrefetchSource

        probe = Y4MReader(path)
        step = max(1, int(round(probe.fps / fps)))
        probe.close()
        source = NativePrefetchSource(path, capacity=8, stride=step)
        for ts, frame in source:
            out.append((ts, frame))
            if max_frames and len(out) >= max_frames:
                break
        source.close()
        return out

    import cv2  # gated: raises ImportError when unavailable

    cap = cv2.VideoCapture(str(path))
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    step = max(1, int(round(src_fps / fps)))
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % step == 0:
            out.append((i / src_fps, cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)))
            if max_frames and len(out) >= max_frames:
                break
        i += 1
    cap.release()
    return out
