"""The trained audio-event classifier, inference only (the port's copy of
the inference half of :mod:`gvl_tpu.audio.event_model`).

A small CNN over 1 s log-mel windows (:mod:`gvl_tpu_torch.audio.mel`) plus
the window's log-RMS as a side input classifies each second into
:data:`EVENT_CLASSES`; every window of a clip goes through one forward on
the card.  The convolutions pad as Flax's "SAME" does
(:class:`~gvl_tpu_torch.perception.ocr_model.SameConv`).  The procedural
audio and the trainer stay in the JAX package.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.nn.layers import gelu_tanh, load_module
from gvl_tpu_torch.perception.ocr_model import SameConv

logger = logging.getLogger(__name__)

# class order is the model output index; names map onto AudioEventType
EVENT_CLASSES = ("silence", "speech", "music", "impact", "ui", "ambient")

# timeline descriptions per class (SILENCE never emits an event)
CLASS_DESCRIPTIONS = {
    "speech": "voice chatter",
    "music": "background music",
    "impact": "impact sound",
    "ui": "UI chime",
    "ambient": "ambient noise",
}

# what each detected sound implies about the gameplay (the QA model learns
# this map; the timeline carries the raw event)
CLASS_IMPLICATIONS = {
    "impact sound": "a collision or hit occurred",
    "UI chime": "a menu or interface interaction happened",
    "background music": "music is playing with no gameplay event",
    "voice chatter": "a character is speaking",
    "ambient noise": "only ambient background is audible",
}


@dataclass
class EventModelConfig:
    sample_rate: int = 16000
    window_seconds: float = 1.0
    n_mels: int = 80                  # Whisper frontend
    n_classes: int = len(EVENT_CLASSES)
    hidden: int = 128

    @property
    def window_samples(self) -> int:
        return int(self.sample_rate * self.window_seconds)

    @property
    def n_frames(self) -> int:
        # log_mel_spectrogram drops the final frame (Whisper convention)
        return self.window_samples // 160 - 1


class AudioEventNet(nn.Module):
    """CNN over ``[B, frames, mels]`` log-mel plus the log-RMS ``[B]``."""

    def __init__(self, config: EventModelConfig):
        super().__init__()
        cin = 1
        for feat in (32, 64, 128):
            self.add_module(f"conv{feat}", SameConv(cin, feat, 3, stride=(2, 2)))
            cin = feat
        self.head1 = nn.Linear(129, config.hidden)
        self.head2 = nn.Linear(config.hidden, config.n_classes)

    def forward(self, mel: torch.Tensor, log_rms: torch.Tensor,
                return_features: bool = False) -> torch.Tensor:
        x = mel[:, None]                            # [B, 1, T, M]
        for feat in (32, 64, 128):
            x = gelu_tanh(getattr(self, f"conv{feat}")(x))
        x = x.mean(dim=(2, 3))                      # [B, 128]
        x = gelu_tanh(self.head1(torch.cat([x, log_rms[:, None]], dim=-1)))
        return x if return_features else self.head2(x)


def _features(wav_batch: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, n]`` waveforms → (log-mel ``[B, T, M]``, log-RMS ``[B]``)."""
    from gvl_tpu_torch.audio.mel import log_mel_spectrogram

    mel = log_mel_spectrogram(wav_batch)
    rms = torch.sqrt(torch.mean(wav_batch ** 2, dim=-1))
    return mel, torch.log10(torch.clamp(rms, min=1e-8))


def load_event_params(path) -> dict:
    """The JAX package's event-model checkpoint as a numpy tree."""
    from gvl_tpu_torch.utils.checkpoints import load_flat_npz

    return load_flat_npz(path)


def load_event_net(params: dict, config: Optional[EventModelConfig] = None,
                   device: str | torch.device = "cuda") -> AudioEventNet:
    """The JAX tree (or the port's state dict) as an :class:`AudioEventNet`
    on ``device``."""
    from gvl_tpu_torch.models.convert import event_params_from_jax

    with torch.device("meta"):
        net = AudioEventNet(config or EventModelConfig())
    state = params if "head1.weight" in params else event_params_from_jax(params)
    return load_module(net, state, device)


class TrainedAudioEmbedder:
    """Chunk embedder over the event net's penultimate features, mean-pooled
    over the chunk's 1 s windows (the trained rung below wav2vec2)."""

    def __init__(self, params: dict, config: Optional[EventModelConfig] = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = config or EventModelConfig()
        self.dim = self.config.hidden
        self.net = load_event_net(params, self.config, self.device)

    @torch.inference_mode()
    def __call__(self, chunk: np.ndarray, sample_rate: int) -> np.ndarray:
        cfg = self.config
        win = cfg.window_samples
        if sample_rate != cfg.sample_rate:
            n_out = int(len(chunk) * cfg.sample_rate / sample_rate)
            chunk = np.interp(np.linspace(0, max(len(chunk) - 1, 1), max(n_out, 1)),
                              np.arange(len(chunk)), chunk).astype(np.float32)
        if len(chunk) < win:
            chunk = np.pad(chunk.astype(np.float32), (0, win - len(chunk)))
        n = len(chunk) // win
        wavs = torch.from_numpy(chunk[: n * win].reshape(n, win).astype(np.float32))
        mel, log_rms = _features(wavs.to(self.device))
        feats = self.net(mel, log_rms, return_features=True)
        return feats.mean(dim=0).float().cpu().numpy()

    @classmethod
    def from_checkpoint(cls, path, config: Optional[EventModelConfig] = None,
                        device: str | torch.device = "cuda") -> "TrainedAudioEmbedder":
        return cls(load_event_params(path), config, device=device)


class TorchAudioEventDetector:
    """Trained-model event backend for
    :meth:`~gvl_tpu_torch.audio.processor.AudioProcessor.detect_audio_events`:
    every whole 1 s window classified in one forward on ``device``."""

    def __init__(self, params: dict, config: Optional[EventModelConfig] = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = config or EventModelConfig()
        self.net = load_event_net(params, self.config, self.device)

    @torch.inference_mode()
    def probabilities(self, wavs: torch.Tensor) -> torch.Tensor:
        """``[N, window]`` waveforms on the card → class probabilities."""
        mel, log_rms = _features(wavs)
        return torch.softmax(self.net(mel, log_rms), dim=-1)

    def __call__(self, audio: np.ndarray, sample_rate: int) -> list[tuple[str, float]]:
        """[(class_name, confidence)] per whole 1 s window of ``audio``."""
        win = self.config.window_samples
        if sample_rate != self.config.sample_rate:
            # linear interpolation: event classes are rate-robust at 1 s
            n_out = int(len(audio) * self.config.sample_rate / sample_rate)
            audio = np.interp(np.linspace(0, len(audio) - 1, n_out),
                              np.arange(len(audio)), audio).astype(np.float32)
        n = len(audio) // win
        if n == 0:
            return []
        wavs = torch.from_numpy(audio[: n * win].reshape(n, win).astype(np.float32))
        conf, cls = self.probabilities(wavs.to(self.device)).max(dim=-1)
        return [(EVENT_CLASSES[int(c)], float(p))
                for c, p in zip(cls.cpu().numpy(), conf.float().cpu().numpy())]
