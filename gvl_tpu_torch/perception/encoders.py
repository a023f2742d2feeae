"""The ``qa_lm`` arm's perception encoders at their trained geometry with
seeded random weights, and synthetic inputs for them: what the card runs
to check and time the encoders (``chip_smoke.py`` phase 11,
``python -m gvl_tpu_torch.device_times --only perception``), where the
trained weights are not copied.

Geometry: the retriever of ``outputs/retriever`` (text tower, 4 layers,
hidden 256, 4 heads, 64 positions), the segmenter of
``outputs/sam_params.npz`` (``SamConfig()``), the OCR nets of
``outputs/ocr_params.npz`` (v2 recognizer), the event net of
``outputs/audio_event_params.npz`` and the byte ASR of ``outputs/asr``
(``asr_config()``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gvl_tpu_torch import resolve_device

CONCEPTS = ("player", "enemy", "boss", "item")
RETRIEVER_CONFIG = dict(hidden_size=256, intermediate_size=1024, num_layers=4, num_heads=4,
                        vocab_size=256, max_position=64, projection_size=256)


@dataclass
class Encoders:
    retriever: object      # TrainedTextEmbedder
    segmenter: object      # SAMConceptSegmenter over a TorchSegmenterBackend
    ocr: object            # TorchOCREngine
    events: object         # TorchAudioEventDetector
    asr: object            # TrainedByteASR


def random_encoders(device: str | torch.device = "cuda", seed: int = 0) -> Encoders:
    """Every encoder of the arm on ``device``, weights drawn in turn from
    one generator seeded with ``seed``."""
    from gvl_tpu_torch.audio.event_model import AudioEventNet, EventModelConfig, \
        TorchAudioEventDetector
    from gvl_tpu_torch.models.siglip import SigLIPTextConfig, SigLIPTextTower
    from gvl_tpu_torch.models.whisper import WhisperModel
    from gvl_tpu_torch.nn.layers import init_state
    from gvl_tpu_torch.perception.ocr_model import OCRModelConfig, TorchOCREngine
    from gvl_tpu_torch.perception.segmenter import SAMConfig, create_sam_segmenter
    from gvl_tpu_torch.training.asr_train import TrainedByteASR, asr_config
    from gvl_tpu_torch.training.retriever_train import TrainedTextEmbedder

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def state(model_cls, config):
        with torch.device("meta"):
            return init_state(model_cls(config), gen, device)

    text_cfg = SigLIPTextConfig(**RETRIEVER_CONFIG)
    asr_cfg = asr_config()
    return Encoders(
        retriever=TrainedTextEmbedder(text_cfg, state(SigLIPTextTower, text_cfg), device),
        segmenter=create_sam_segmenter(SAMConfig(), use_model=True, device=device,
                                       generator=gen),
        ocr=TorchOCREngine(OCRModelConfig(rec_arch="v2"), generator=gen, device=device),
        events=TorchAudioEventDetector(state(AudioEventNet, EventModelConfig()),
                                       device=device),
        asr=TrainedByteASR(asr_cfg, state(WhisperModel, asr_cfg), device=device),
    )


_SUBJECTS = ("the player", "an enemy", "the boss", "a health pickup", "the hero",
             "a monster", "the final boss", "some loot")
_ACTIONS = ("appears", "moves left", "moves right", "takes damage", "is defeated",
            "drops an item", "jumps", "attacks")
_PLACES = ("near the bridge", "in the cave", "at the top of the screen",
           "beside the door", "in the arena", "on the left")


def retrieval_texts(n: int, seed: int = 0) -> tuple[list[str], list[str]]:
    """``n`` distinct event descriptions and a query naming each."""
    rng = np.random.default_rng(seed)
    descs: list[str] = []
    while len(descs) < n:
        d = (f"{rng.choice(_SUBJECTS)} {rng.choice(_ACTIONS)} {rng.choice(_PLACES)} "
             f"at {int(rng.integers(0, 60)):02d}:{int(rng.integers(0, 60)):02d}")
        if d not in descs:
            descs.append(d)
    return [f"when does {d.split(' at ')[0]}?" for d in descs], descs


def gameplay_frames(n: int, height: int = 320, width: int = 568, seed: int = 0) -> list:
    """uint8 ``[height, width, 3]`` frames: a textured dark background,
    squares, triangles, disks and diamonds in four colours drifting 4 px a
    frame, and a HUD bar."""
    rng = np.random.default_rng(seed)
    base = rng.integers(15, 70, (height, width, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:height, 0:width]
    shapes = [(kind, colour, int(rng.integers(20, height - 20)), int(rng.integers(20, width - 20)),
               int(rng.integers(8, 28)))
              for kind, colour in zip(("square", "triangle", "disk", "diamond") * 2,
                                      ((60, 90, 220), (220, 60, 50), (160, 60, 200),
                                       (230, 200, 50)) * 2)]
    frames = []
    for i in range(n):
        frame = base.copy()
        for kind, colour, cy, cx, r in shapes:
            cx = (cx + 4 * i) % width
            dy, dx = np.abs(yy - cy), np.abs(xx - cx)
            hit = {"square": (dy <= r) & (dx <= r),
                   "triangle": (yy >= cy - r) & (yy <= cy + r) & (2 * dx <= yy - cy + r),
                   "disk": dy ** 2 + dx ** 2 <= r * r,
                   "diamond": dy + dx <= r}[kind]
            frame[hit] = colour
        frame[8:20, 16:16 + 3 * (60 - i % 60)] = (40, 220, 60)
        frames.append(frame)
    return frames


def hud_frames(n: int, height: int = 360, width: int = 640, seed: int = 0) -> list:
    """uint8 gray-ish frames with bright glyph-like strokes in HUD rows."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n):
        frame = rng.integers(10, 60, (height, width, 3)).astype(np.uint8)
        for _ in range(int(rng.integers(2, 5))):
            y, x = int(rng.integers(0, height - 24)), int(rng.integers(0, width - 200))
            for g in range(int(rng.integers(3, 12))):
                gx = x + 14 * g
                frame[y + 4:y + 20, gx + 2:gx + 4] = 230
                frame[y + 4:y + 6, gx + 2:gx + 10] = 230
                if g % 2:
                    frame[y + 11:y + 13, gx + 2:gx + 10] = 230
        frames.append(frame)
    return frames


def soundtrack(seconds: int, sample_rate: int = 16000, seed: int = 0) -> np.ndarray:
    """f32 mono audio, one second at a time: harmonic "speech" with
    syllabic amplitude, a chord, a decaying noise burst, beeps, noise, and
    near silence, in turn."""
    rng = np.random.default_rng(seed)
    t = np.arange(sample_rate) / sample_rate
    parts = []
    for s in range(seconds):
        kind = s % 6
        if kind == 0:
            f0 = rng.uniform(100, 250)
            wav = sum(a * np.sin(2 * np.pi * f0 * h * t) for h, a in ((1, 1), (2, .7), (3, .9)))
            wav *= 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 8) * t))
        elif kind == 1:
            root = rng.uniform(110, 440)
            wav = sum(np.sin(2 * np.pi * root * r * t) for r in (1.0, 1.26, 1.5))
        elif kind == 2:
            wav = rng.normal(0, 1, sample_rate) * np.exp(-12 * t)
        elif kind == 3:
            wav = np.sin(2 * np.pi * rng.uniform(700, 2400) * t) * (np.sin(2 * np.pi * 4 * t) > 0)
        elif kind == 4:
            wav = rng.normal(0, 0.3, sample_rate)
        else:
            parts.append(rng.normal(0, 1e-4, sample_rate))
            continue
        parts.append(wav / (np.abs(wav).max() + 1e-9) * rng.uniform(0.05, 0.5))
    return np.concatenate(parts).astype(np.float32)
