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

from pathlib import Path

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



@dataclass
class Checkpoints:
    segmenter: str         # flat npz, as outputs/sam_params.npz
    events: str            # flat npz, as outputs/audio_event_params.npz
    asr: str               # directory, as outputs/asr
    retriever: str         # directory, as outputs/retriever
    minisiglip: str        # directory, as outputs/minisiglip
    videomae: str          # directory, as outputs/videomae (the clip classifier)
    hico: str              # flat npz, as outputs/hico_params.npz (FRAME → CLIP pool)


def checkpoints_in(out_dir) -> Checkpoints:
    """The paths :func:`write_random_checkpoints` writes under ``out_dir``."""
    out = Path(out_dir)
    return Checkpoints(str(out / "sam_params.npz"), str(out / "audio_event_params.npz"),
                       str(out / "asr"), str(out / "retriever"), str(out / "minisiglip"),
                       str(out / "videomae"), str(out / "hico_params.npz"))


def write_random_checkpoints(out_dir, device: str | torch.device = "cuda",
                             seed: int = 0) -> Checkpoints:
    """Checkpoints of the segmenter, event net, byte ASR, retriever,
    mini-SigLIP pair (vision 384 x 6 layers x 6 heads at 128 px, text 384 x
    4 layers), clip classifier (VideoMAE 256 x 6 layers x 4 heads, 16
    frames at 112 px, and its three heads) and HiCo compressor (1408 wide,
    8 heads; the FRAME → CLIP pool, as the trained file holds) at their
    trained geometry, in the repository's own format, holding seeded random
    weights drawn as :func:`random_encoders` draws them.

    They stand in for the trained files of ``outputs/`` wherever those are
    not at hand, so that the arm's checkpoint ladders resolve to the models
    and not to their fakes.  Each state dict becomes the JAX package's tree
    through :func:`gvl_tpu_torch.models.convert.tree_from_state`, on the
    layouts of ``checkpoint_layouts.json`` (the key paths and shapes of the
    trained files)."""
    import json
    from dataclasses import asdict

    from gvl_tpu_torch.audio.event_model import AudioEventNet, EventModelConfig
    from gvl_tpu_torch.models import convert
    from gvl_tpu_torch.models.sam import PromptableSegmenter, SamConfig
    from gvl_tpu_torch.models.siglip import SigLIPTextConfig, SigLIPTextTower
    from gvl_tpu_torch.models.whisper import WhisperModel
    from gvl_tpu_torch.nn.layers import init_state
    from gvl_tpu_torch.training.asr_train import asr_config
    from gvl_tpu_torch.utils.checkpoints import save_flat_npz, split_key

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    layouts = json.loads((Path(__file__).with_name("checkpoint_layouts.json")).read_text())

    def skeleton(family: str) -> dict:
        tree: dict = {}
        for key, shape in layouts[family].items():
            *parents, leaf = split_key(key)
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = tuple(shape)
        return tree

    def write(family, model_cls, config, to_jax, path):
        with torch.device("meta"):
            state = init_state(model_cls(config), gen, device)
        save_flat_npz(convert.tree_from_state(to_jax, skeleton(family), state), path)

    out = Path(out_dir)
    for sub in ("asr", "retriever", "minisiglip", "videomae"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    text_cfg, sam_cfg, asr_cfg = SigLIPTextConfig(**RETRIEVER_CONFIG), SamConfig(), asr_config()
    paths = checkpoints_in(out)
    write("retriever", SigLIPTextTower, text_cfg,
          lambda t: convert.siglip_text_params_from_jax(t, text_cfg.num_layers),
          out / "retriever" / "params.npz")
    (out / "retriever" / "retriever_config.json").write_text(
        json.dumps({"model": asdict(text_cfg)}, indent=2))
    write("segmenter", PromptableSegmenter, sam_cfg,
          lambda t: convert.sam_params_from_jax(t, sam_cfg), paths.segmenter)
    write("events", AudioEventNet, EventModelConfig(), convert.event_params_from_jax,
          paths.events)
    write("asr", WhisperModel, asr_cfg, lambda t: convert.whisper_params_from_jax(t, asr_cfg),
          out / "asr" / "params.npz")
    (out / "asr" / "asr_config.json").write_text(json.dumps({"model": asdict(asr_cfg)},
                                                            indent=2))

    from gvl_tpu_torch.temporal.hico import HiCoConfig, HierarchicalCompressor
    from gvl_tpu_torch.training import siglip_train, videomae_train

    vision_cfg = siglip_train.minisiglip_vision_config()
    mini_text_cfg = siglip_train.minisiglip_text_config()
    write("minisiglip", lambda _: siglip_train.MiniSigLIP(vision_cfg, mini_text_cfg), None,
          lambda t: convert.minisiglip_params_from_jax(t, vision_cfg, mini_text_cfg),
          out / "minisiglip" / "params.npz")
    vision = {k: v for k, v in asdict(vision_cfg).items() if not k.startswith("quant")}
    (out / "minisiglip" / "minisiglip_config.json").write_text(
        json.dumps({"vision": vision, "text": asdict(mini_text_cfg)}, indent=2))
    clip_cfg = videomae_train.mini_videomae_config()
    write("videomae", videomae_train.ClipClassifier, clip_cfg,
          lambda t: convert.clip_classifier_params_from_jax(t, clip_cfg),
          out / "videomae" / "params.npz")
    (out / "videomae" / "videomae_config.json").write_text(json.dumps({
        "model": asdict(clip_cfg), "directions": list(videomae_train.DIRECTION_NAMES),
        "concepts": list(videomae_train.CONCEPTS), "events": list(videomae_train.EVENTS)},
        indent=2))
    write("hico", lambda cfg: HierarchicalCompressor(cfg, pools=("frame_to_clip",)),
          HiCoConfig(), convert.hico_params_from_jax, paths.hico)
    return paths

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
