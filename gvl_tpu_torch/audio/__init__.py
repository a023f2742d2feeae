"""Audio: log-mel frontend, event classifier, processor (port of gvl_tpu.audio)."""

from gvl_tpu_torch.audio.processor import (
    AudioAnalysisResult,
    AudioConfig,
    AudioEvent,
    AudioEventParser,
    AudioEventType,
    AudioPreprocessor,
    AudioProcessor,
    DeterministicFakeASR,
    HashAudioEmbedder,
    TranscriptionSegment,
    Wav2Vec2TorchEmbedder,
    build_audio_stack,
    create_audio_processor,
)
from gvl_tpu_torch.audio.event_model import (
    AudioEventNet,
    EventModelConfig,
    TorchAudioEventDetector,
    evaluate_event_model,
    train_event_model,
)
from gvl_tpu_torch.audio.mel import log_mel_spectrogram, mel_filterbank

__all__ = [
    "AudioEventNet",
    "EventModelConfig",
    "TorchAudioEventDetector",
    "train_event_model",
    "evaluate_event_model",
    "AudioEventType",
    "TranscriptionSegment",
    "AudioEvent",
    "AudioAnalysisResult",
    "AudioConfig",
    "AudioPreprocessor",
    "AudioEventParser",
    "AudioProcessor",
    "DeterministicFakeASR",
    "HashAudioEmbedder",
    "Wav2Vec2TorchEmbedder",
    "build_audio_stack",
    "create_audio_processor",
    "mel_filterbank",
    "log_mel_spectrogram",
]
