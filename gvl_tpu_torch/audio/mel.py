"""Whisper-compatible log-mel frontend (the port's copy of
:mod:`gvl_tpu.audio.mel`).

The slaney filterbank is built once on the host (numpy);
:func:`log_mel_spectrogram` frames, windows, transforms and projects in
PyTorch on the waveform's device; :func:`log_mel_numpy` is its host twin.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80


def _hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale (linear below 1 kHz, log above)."""
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    mel = np.where(
        log_region,
        15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
        mel,
    )
    return mel


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    f = mel * (200.0 / 3)
    log_region = mel >= 15.0
    f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (mel - 15.0)), f)
    return f


def mel_filterbank(
    sample_rate: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
    n_mels: int = N_MELS,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """[n_mels, n_fft//2 + 1] slaney-normalized triangular filters."""
    fmax = fmax if fmax is not None else sample_rate / 2
    fft_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    # slaney norm: each filter integrates to ~constant energy
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def log_mel_spectrogram(
    wav,
    sample_rate: int = SAMPLE_RATE,
    n_mels: int = N_MELS,
    filters: np.ndarray | None = None,
) -> torch.Tensor:
    """Whisper-style log-mel ``[B, frames, n_mels]`` (or ``[frames, n_mels]``)
    of a waveform tensor (or numpy array, taken to the CPU): centred STFT
    (reflect pad, periodic Hann window), power, mel projection, log10,
    clamp to (max - 8), then (x + 4) / 4; the final frame is dropped, as
    Whisper does."""
    wav = torch.as_tensor(wav, dtype=torch.float32)
    squeeze = wav.ndim == 1
    if squeeze:
        wav = wav[None]
    window = torch.from_numpy(np.hanning(N_FFT + 1)[:-1].astype(np.float32)).to(wav.device)
    pad = N_FFT // 2
    x = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP_LENGTH) * window
    power = torch.fft.rfft(frames, n=N_FFT, dim=-1).abs().pow(2)[:, :-1]
    mel_mat = torch.from_numpy(
        filters if filters is not None else mel_filterbank(sample_rate, N_FFT, n_mels)
    ).to(wav.device)
    log_spec = torch.log10(torch.clamp(power @ mel_mat.T, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec[0] if squeeze else log_spec


def log_mel_numpy(
    wav: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    n_mels: int = N_MELS,
    filters: np.ndarray | None = None,
) -> np.ndarray:
    """Host-side (numpy) twin of :func:`log_mel_spectrogram`."""
    wav = np.asarray(wav, np.float32)
    squeeze = wav.ndim == 1
    if squeeze:
        wav = wav[None]
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    pad = N_FFT // 2
    x = np.pad(wav, ((0, 0), (pad, pad)), mode="reflect")
    n_frames = 1 + (x.shape[-1] - N_FFT) // HOP_LENGTH
    idx = (np.arange(n_frames)[:, None] * HOP_LENGTH
           + np.arange(N_FFT)[None, :])
    frames = x[:, idx] * window[None, None, :]
    power = np.abs(np.fft.rfft(frames, n=N_FFT, axis=-1)) ** 2
    power = power[:, :-1]
    mel_mat = (filters if filters is not None
               else mel_filterbank(sample_rate, N_FFT, n_mels))
    mel = power @ mel_mat.T
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(
        log_spec, log_spec.max(axis=(1, 2), keepdims=True) - 8.0)
    log_spec = ((log_spec + 4.0) / 4.0).astype(np.float32)
    return log_spec[0] if squeeze else log_spec
