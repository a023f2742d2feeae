"""The trained audio-event classifier, inference only (the port's copy of
the inference half of :mod:`gvl_tpu.audio.event_model`).

A small CNN over 1 s log-mel windows (:mod:`gvl_tpu_torch.audio.mel`) plus
the window's log-RMS as a side input classifies each second into
:data:`EVENT_CLASSES`; every window of a clip goes through one forward on
the card.  The convolutions pad as Flax's "SAME" does
(:class:`~gvl_tpu_torch.perception.ocr_model.SameConv`).  The procedural
event audio (:func:`synth_event`, for the synthetic clips' soundtrack) is
copied; the trainer stays in the JAX package.
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


# --------------------------------------------------------------------------
# Procedural audio synthesis (fully offline training data)
# --------------------------------------------------------------------------

def _colored_noise(rng: np.random.Generator, n: int, rolloff: float) -> np.ndarray:
    """Noise with a 1/f**rolloff spectral envelope."""
    spec = rng.normal(size=n // 2 + 1) + 1j * rng.normal(size=n // 2 + 1)
    freqs = np.maximum(np.arange(n // 2 + 1, dtype=np.float64), 1.0)
    spec = spec / freqs ** rolloff
    wav = np.fft.irfft(spec, n)
    return (wav / (np.abs(wav).max() + 1e-9)).astype(np.float32)


def _tone(n: int, sr: int, f0: float, harmonics: int = 1,
          decay: float = 0.0) -> np.ndarray:
    t = np.arange(n) / sr
    wav = np.zeros(n, np.float32)
    for h in range(1, harmonics + 1):
        wav += np.sin(2 * np.pi * f0 * h * t).astype(np.float32) / h
    if decay > 0:
        wav *= np.exp(-decay * t).astype(np.float32)
    return wav / (np.abs(wav).max() + 1e-9)


def synth_event(rng: np.random.Generator, cls: str,
                config: EventModelConfig) -> np.ndarray:
    """One window of procedural audio for an event class ∈ EVENT_CLASSES."""
    n, sr = config.window_samples, config.sample_rate
    t = np.arange(n) / sr
    if cls == "silence":
        return (rng.normal(0, rng.uniform(1e-5, 4e-4), n)
                ).astype(np.float32)
    if cls == "speech":
        if rng.random() < 0.5:
            # the OTHER procedural speech in this codebase: the byte
            # ASR's formant synthesis.  Without this variant the event
            # classifier labels ASR-style speech as music/impact (the
            # measured cross-subsystem mismatch on audio-enabled
            # synthetic clips), which breaks event-gated transcription.
            from gvl_tpu_torch.training.asr_train import (
                SpeakerProfile,
                synth_speech,
            )

            words = ("enemy ahead", "take cover", "press it", "run now",
                     "over here", "watch out", "go left", "help me")
            text = " ".join(str(rng.choice(words))
                            for _ in range(int(rng.integers(1, 3))))
            wav = synth_speech(rng, text,
                               profile=SpeakerProfile.sample(rng),
                               total_seconds=config.window_seconds
                               ).astype(np.float64)[:n]
            if len(wav) < n:
                wav = np.pad(wav, (0, n - len(wav)))
            level = rng.uniform(0.05, 0.4)
            wav = wav / (np.abs(wav).max() + 1e-9) * level
            return wav.astype(np.float32)
        # harmonic source with wandering f0 + syllabic (3-8 Hz) AM +
        # formant-ish band emphasis via modulated harmonics amplitude
        f0 = rng.uniform(90, 280)
        drift = np.cumsum(rng.normal(0, 0.4, n)) / sr
        phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.1 * np.sin(
            2 * np.pi * rng.uniform(2, 5) * t)) + drift) / sr
        wav = np.zeros(n, np.float64)
        for h, amp in ((1, 1.0), (2, 0.7), (3, 0.9), (4, 0.4), (5, 0.25)):
            wav += amp * np.sin(h * phase)
        syllab = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 8) * t
                                   + rng.uniform(0, 6.28)))
        # pauses between "words"
        gate = (np.sin(2 * np.pi * rng.uniform(0.8, 1.6) * t
                       + rng.uniform(0, 6.28)) > -0.6).astype(np.float64)
        wav = wav * syllab * gate + rng.normal(0, 0.02, n)
        level = rng.uniform(0.05, 0.4)
    elif cls == "music":
        # sustained chord (root + third + fifth, harmonic-rich) + vibrato
        root = rng.uniform(110, 440)
        wav = np.zeros(n, np.float64)
        for ratio in (1.0, 1.26, 1.5):
            vib = 1 + 0.01 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
            wav += _tone(n, sr, root * ratio, harmonics=4) * vib
        if rng.random() < 0.5:  # rhythmic pulse
            wav *= 0.7 + 0.3 * (np.sin(2 * np.pi * rng.uniform(1, 3) * t)
                                > 0)
        level = rng.uniform(0.05, 0.5)
    elif cls == "impact":
        # wideband burst with exponential decay + low-frequency thump,
        # placed at a random onset inside the window
        wav = np.zeros(n, np.float64)
        onset = int(rng.uniform(0, 0.6) * n)
        dur = int(rng.uniform(0.1, 0.4) * sr)
        burst = _colored_noise(rng, dur, rng.uniform(0.0, 0.5))
        burst = burst * np.exp(-rng.uniform(6, 20) * np.arange(dur) / sr)
        thump = _tone(dur, sr, rng.uniform(40, 90), harmonics=2,
                      decay=rng.uniform(8, 18))
        wav[onset:onset + dur] = burst + 0.8 * thump
        wav += rng.normal(0, 0.01, n)
        level = rng.uniform(0.2, 0.9)
    elif cls == "ui":
        # repeating pure beeps or a rising 2-3 note arpeggio chirp
        wav = np.zeros(n, np.float64)
        f = rng.uniform(700, 2400)
        notes = int(rng.integers(2, 5))
        dur = int(rng.uniform(0.05, 0.12) * sr)
        gap = int(rng.uniform(0.04, 0.2) * sr)
        pos = int(rng.uniform(0, 0.3) * n)
        for k in range(notes):
            if pos + dur > n:
                break
            step = 1.26 ** k if rng.random() < 0.6 else 1.0
            wav[pos:pos + dur] = _tone(dur, sr, f * step, harmonics=2,
                                       decay=rng.uniform(0, 20))
            pos += dur + gap
        level = rng.uniform(0.1, 0.6)
    else:  # ambient
        wav = _colored_noise(rng, n, rng.uniform(0.8, 1.8)).astype(
            np.float64)
        wav *= 1 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t)
        level = rng.uniform(0.01, 0.12)
    wav = wav / (np.abs(wav).max() + 1e-9) * level
    return wav.astype(np.float32)


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
