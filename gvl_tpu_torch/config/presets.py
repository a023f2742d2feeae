"""Configuration presets ``light`` / ``standard`` / ``full`` (the port's copy
of :mod:`gvl_tpu.config.presets`, values unchanged).

Each preset says which perception models run, at what rate, from which
checkpoints, and how the reasoning core answers.  The fields sized for the
JAX package's TPU topologies (``mesh``, ``buckets``, ``device``,
``estimated_hbm_gb``) are carried as data: nothing in the port reads them.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field, asdict
from enum import Enum
from pathlib import Path
from typing import Any, Optional

logger = logging.getLogger(__name__)


class PresetName(Enum):
    """Available configuration presets."""

    LIGHT = "light"        # 1 chip
    STANDARD = "standard"  # 4 chips
    FULL = "full"          # 8 chips


@dataclass
class MeshConfig:
    """Device-mesh layout for this preset.

    ``data`` shards batches, ``model`` shards weights (tensor parallel).
    The product must equal the chip count; shapes here are *requested* —
    The JAX package's ``MeshManager`` shrinks them to whatever is
    actually attached so every preset also runs single-chip.
    """

    data_axis: int = 1
    model_axis: int = 1

    @property
    def num_devices(self) -> int:
        return self.data_axis * self.model_axis


@dataclass
class BucketConfig:
    """Static padding buckets — XLA compiles one program per bucket.

    The PyTorch reference pads to per-batch max and eats recompiles; on TPU
    every dynamic dimension must come from this fixed menu.
    """

    # masked-region batch sizes for the semantic encoder
    region_batch: tuple[int, ...] = (1, 4, 8, 16)
    # NaFlex resize targets (sequence lengths in patches)
    vision_seq_lens: tuple[int, ...] = (256, 576, 784)
    # timeline events entering semantic retrieval
    retrieval_batch: tuple[int, ...] = (16, 64, 256, 1024)
    # decode-time prompt-length buckets
    prompt_lens: tuple[int, ...] = (512, 1024, 2048, 4096, 8192)


@dataclass
class PerceptionConfig:
    """Visual perception stack."""

    # open-vocabulary segmenter (SAM3-class)
    use_sam: bool = True
    sam_model: str = "gvl/sam3-tpu"
    sam_dtype: str = "float32"   # fp32 master weights, bf16 compute
    sam3_fps: float = 0.5        # segmenter runs at a lower rate than fps
    # "auto": the model when sam_checkpoint exists, else deterministic
    # fake; "jax": always the model (random-init if no
    # checkpoint); "open_vocab": SAM proposals × SigLIP text scoring
    # from HF checkpoint dirs (sam_vit_dir + siglip_checkpoint);
    # "fake": always the hash-seeded stand-in
    sam_backend: str = "auto"
    sam_vit_dir: Optional[str] = None   # local HF sam-vit-* directory
    sam_checkpoint: Optional[str] = "outputs/sam_params.npz"

    # region semantic encoder (SigLIP2-class)
    use_siglip: bool = True
    siglip_model: str = "google/siglip2-so400m-patch14-384"
    siglip_batch_size: int = 16
    siglip_dtype: str = "bfloat16"
    # W8A8 tower blocks on the int8 MXU (~1.5-2x throughput on v5e;
    # pooled-embedding cosine vs bf16 ≈ 0.9999)
    siglip_int8: bool = False
    # fused W8A8 serving tower (gvl_tpu_torch.models.siglip_fused):
    # calibrated static activation scales baked at build time; measured
    # 275 vs 197 img/s over bf16 at so400m on one v5e.  Applies to the
    # so400m/HF towers only (the mini tower is already cheap); other
    # platforms lower to the exact XLA reference paths
    siglip_fused: bool = True
    # same ladder as sam_checkpoint/asr_checkpoint: the self-trained
    # mini-SigLIP (scripts/train_siglip.py) auto-loads when this dir
    # resolves — it also arms the segmenter-free zero-shot frame
    # labeler for the gvp_light arm (perception/frame_labeler.py);
    # deterministic fake below it.  An HF-layout so400m dir works too.
    siglip_backend: str = "auto"
    siglip_checkpoint: Optional[str] = "outputs/minisiglip"

    # temporal clip encoder (VideoMAE-class)
    use_videomae: bool = True
    videomae_model: str = "MCG-NJU/videomae-base"
    videomae_dtype: str = "bfloat16"
    # local HF VideoMAE directory OR a scripts/train_videomae.py
    # checkpoint — same auto-ladder as sam_checkpoint/asr_checkpoint:
    # HF tower > self-trained mini tower > deterministic hash fake
    videomae_checkpoint: Optional[str] = "outputs/videomae"

    # OCR
    use_ocr: bool = True
    ocr_backend: str = "native"  # "native" (det/rec engine,
    # falls back to fake without outputs/ocr_params.npz), "tesseract",
    # "jax" (explicit checkpoint), "fake"


@dataclass
class AudioConfig:
    """Audio stack: self-supervised features + ASR."""

    use_audio: bool = True
    use_wav2vec: bool = True
    wav2vec_model: str = "facebook/wav2vec2-large"
    use_whisper: bool = True
    whisper_model: str = "openai/whisper-base"
    whisper_language: Optional[str] = None
    sample_rate: int = 16000
    # local HF checkpoint dirs — auto-ladder like sam_checkpoint: the
    # Whisper ASR / wav2vec2 chunk embedder load when these resolve,
    # deterministic fakes run otherwise (gvl_tpu_torch.audio.build_audio_stack)
    whisper_checkpoint: Optional[str] = None
    wav2vec2_checkpoint: Optional[str] = None
    # fixed wav2vec2 chunk bucket (seconds) — one compile per bucket
    wav2vec2_chunk_seconds: float = 10.0
    # trained audio event classifier (gvl_tpu_torch.audio.event_model) — the
    # model rung above the spectral heuristic; auto-loads when the npz
    # exists, exactly like sam_checkpoint
    event_checkpoint: Optional[str] = "outputs/audio_event_params.npz"
    # self-trained byte ASR (gvl_tpu_torch.training.asr_train) — the trained
    # rung below whisper_checkpoint: used when no HF Whisper dir
    # resolves but this checkpoint exists; deterministic fake below it
    asr_checkpoint: Optional[str] = "outputs/asr"


@dataclass
class TemporalConfig:
    """Hierarchical token compression over long videos."""

    use_hico: bool = True
    hico_model: str = "gvl/hico-tpu"
    clip_duration_sec: float = 4.0
    frames_per_clip: int = 16
    max_context_tokens: int = 256
    context_window_minutes: float = 5.0


@dataclass
class ReasoningConfig:
    """The VLM reasoning core."""

    model_name: str = "Qwen/Qwen3-VL-8B-Instruct"
    use_flash_attention: bool = True
    dtype: str = "bfloat16"
    max_new_tokens: int = 1024

    use_lora: bool = True
    lora_path: Optional[str] = "outputs/lora_adapter"
    lora_rank: int = 16
    lora_alpha: int = 32

    use_projectors: bool = True
    projector_path: Optional[str] = "outputs/projector_weights.pt"

    # local LLM checkpoint for the text backend — same auto-ladder as
    # sam_checkpoint: a qa_lm dir (scripts/train_qa_lm.py) or HF text
    # checkpoint routes through create_reasoning_core when it resolves,
    # grounded deterministic fake otherwise
    llm_checkpoint: Optional[str] = None

    # KV-cache page size for continuous batching
    kv_page_tokens: int = 256
    max_batch_slots: int = 8


@dataclass
class InferenceConfig:
    """End-to-end inference behavior."""

    fps: float = 1.0
    batch_size: int = 1
    use_feature_cache: bool = True
    cache_dir: str = "data/outputs/cache"

    use_trigger_detection: bool = True
    trigger_concepts: list[str] = field(
        default_factory=lambda: ["boss", "enemy", "player"]
    )
    trigger_confidence_threshold: float = 0.7


@dataclass
class SystemConfig:
    """Full framework configuration for one preset."""

    preset_name: PresetName
    perception: PerceptionConfig
    audio: AudioConfig
    temporal: TemporalConfig
    reasoning: ReasoningConfig
    inference: InferenceConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    buckets: BucketConfig = field(default_factory=BucketConfig)

    device: str = "tpu"
    estimated_hbm_gb: float = 16.0

    def get_hbm_breakdown(self) -> dict[str, float]:
        """Per-component HBM estimate in GB (bf16 weights + activations)."""
        breakdown: dict[str, float] = {"qwen3_vl_8b": 16.0}
        if self.perception.use_sam:
            breakdown["sam3"] = 4.0
        if self.perception.use_siglip:
            breakdown["siglip"] = 2.0
        if self.perception.use_videomae:
            breakdown["videomae"] = 1.0
        if self.audio.use_audio:
            breakdown["audio_whisper"] = 1.0
        if self.temporal.use_hico:
            breakdown["hico"] = 2.0
        breakdown["kv_cache"] = 0.5 * self.reasoning.max_batch_slots
        return breakdown

    # Back-compat alias (the reference exposes a VRAM breakdown).
    get_vram_breakdown = get_hbm_breakdown

    def to_dict(self) -> dict[str, Any]:
        doc = asdict(self)
        doc["preset_name"] = self.preset_name.value
        return doc

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2, default=list))
        logger.info("Configuration saved to %s", path)


def _light() -> SystemConfig:
    """1-chip preset: no segmenter/VideoMAE/HiCo, small ASR, 0.5 fps."""
    return SystemConfig(
        preset_name=PresetName.LIGHT,
        perception=PerceptionConfig(
            use_sam=False,
            siglip_batch_size=8,
            use_videomae=False,
            ocr_backend="native",
        ),
        audio=AudioConfig(
            use_wav2vec=False,
            whisper_model="openai/whisper-small",
        ),
        temporal=TemporalConfig(
            use_hico=False,
            context_window_minutes=2.0,
            max_context_tokens=128,
        ),
        reasoning=ReasoningConfig(max_new_tokens=512, max_batch_slots=2),
        inference=InferenceConfig(fps=0.5, use_trigger_detection=False),
        mesh=MeshConfig(data_axis=1, model_axis=1),
        estimated_hbm_gb=14.0,
    )


def _standard() -> SystemConfig:
    """v5e-4 preset: full perception stack at 1 fps, LLM TP over 4 chips."""
    return SystemConfig(
        preset_name=PresetName.STANDARD,
        perception=PerceptionConfig(sam3_fps=0.5, siglip_batch_size=16),
        audio=AudioConfig(whisper_model="openai/whisper-base"),
        temporal=TemporalConfig(context_window_minutes=5.0),
        reasoning=ReasoningConfig(max_new_tokens=1024, max_batch_slots=4),
        inference=InferenceConfig(fps=1.0),
        mesh=MeshConfig(data_axis=1, model_axis=4),
        estimated_hbm_gb=40.0,
    )


def _full() -> SystemConfig:
    """v5e-8 preset: everything on, 2 fps, whisper-large, dp2×tp4."""
    return SystemConfig(
        preset_name=PresetName.FULL,
        perception=PerceptionConfig(
            sam3_fps=1.0,
            siglip_batch_size=32,
        ),
        audio=AudioConfig(whisper_model="openai/whisper-large-v3"),
        temporal=TemporalConfig(
            frames_per_clip=32,
            context_window_minutes=10.0,
            max_context_tokens=512,
        ),
        reasoning=ReasoningConfig(max_new_tokens=2048, max_batch_slots=8),
        inference=InferenceConfig(
            fps=2.0,
            batch_size=2,
            trigger_concepts=[
                "boss", "enemy", "player", "item", "npc", "projectile",
            ],
        ),
        mesh=MeshConfig(data_axis=2, model_axis=4),
        estimated_hbm_gb=80.0,
    )


_FACTORIES = {
    PresetName.LIGHT: _light,
    PresetName.STANDARD: _standard,
    PresetName.FULL: _full,
}


def load_preset(preset_name: PresetName | str) -> SystemConfig:
    """Build a fresh :class:`SystemConfig` for the named preset.

    Example::

        config = load_preset("light")
        config.estimated_hbm_gb   # 14.0
    """
    if isinstance(preset_name, str):
        preset_name = PresetName(preset_name.lower())
    config = _FACTORIES[preset_name]()
    logger.info(
        "Loaded preset '%s' (~%.0f GB HBM over %d chip(s))",
        preset_name.value, config.estimated_hbm_gb, config.mesh.num_devices,
    )
    return config


def print_preset_summary() -> None:
    """Print a comparison table of all presets."""
    rows = [load_preset(p) for p in PresetName]
    cols = [
        ("preset", lambda c: c.preset_name.value),
        ("chips", lambda c: str(c.mesh.num_devices)),
        ("hbm_gb", lambda c: f"{c.estimated_hbm_gb:.0f}"),
        ("fps", lambda c: f"{c.inference.fps}"),
        ("sam", lambda c: "yes" if c.perception.use_sam else "no"),
        ("hico", lambda c: "yes" if c.temporal.use_hico else "no"),
        ("whisper", lambda c: c.audio.whisper_model.split("/")[-1]),
        ("context_min", lambda c: f"{c.temporal.context_window_minutes:.0f}"),
    ]
    header = " | ".join(name for name, _ in cols)
    print(header)
    print("-" * len(header))
    for cfg in rows:
        print(" | ".join(fn(cfg) for _, fn in cols))
