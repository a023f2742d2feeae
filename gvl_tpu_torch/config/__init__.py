"""Hardware-aware configuration presets."""

from gvl_tpu_torch.config.presets import (
    AudioConfig,
    InferenceConfig,
    PerceptionConfig,
    PresetName,
    ReasoningConfig,
    SystemConfig,
    TemporalConfig,
    load_preset,
    print_preset_summary,
)

__all__ = [
    "PresetName",
    "PerceptionConfig",
    "AudioConfig",
    "TemporalConfig",
    "ReasoningConfig",
    "InferenceConfig",
    "SystemConfig",
    "load_preset",
    "print_preset_summary",
]
