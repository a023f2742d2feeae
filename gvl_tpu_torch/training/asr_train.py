"""The self-trained byte-level ASR model, inference only (the port's copy of
the inference half of :mod:`gvl_tpu.training.asr_train`).

A ~10M-parameter Whisper geometry (:mod:`gvl_tpu_torch.models.whisper`)
over the byte vocabulary: 6 s windows (600 mel frames, 300 encoder
positions), greedy decode of up to 95 bytes.  The procedural speech
(:func:`synth_speech`, for the synthetic clips' soundtrack) is copied; the
trainer stays in the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.byte_tokenizer import BOS_ID, EOS_ID, VOCAB_SIZE
from gvl_tpu_torch.models.whisper import WhisperConfig, greedy_decode_cached, load_whisper
from gvl_tpu_torch.utils.checkpoints import load_flat_npz

SAMPLE_RATE = 16000

# --------------------------------------------------------------------------
# Procedural speech synthesis
# --------------------------------------------------------------------------

# the speakable alphabet: every other byte renders as silence
ALPHABET = "abcdefghijklmnopqrstuvwxyz0123456789"
VOWELS = set("aeiou")

# per-character formant table, built deterministically: distinct
# (F1, F2) pairs spread over the mel-resolvable band.  36 chars < 6×13
# grid, so no two characters collide in BOTH formants.
_F1 = 320.0 + 80.0 * (np.arange(len(ALPHABET)) % 6)          # 320-720 Hz
_F2 = 950.0 + 165.0 * (np.arange(len(ALPHABET)) % 13)        # 950-2930 Hz
# voicing: vowels always voiced; consonants/digits voiced on a fixed
# pattern (roughly "sonorant" vs "fricative" split)
_VOICED = np.array([
    (c in VOWELS) or (i % 3 != 0)
    for i, c in enumerate(ALPHABET)
])


@dataclass(frozen=True)
class SpeakerProfile:
    """Utterance-level nuisance parameters the ASR must be invariant to."""

    f0: float = 140.0            # glottal pitch, Hz
    formant_scale: float = 1.0   # vocal-tract length proxy
    char_dur: float = 0.075      # seconds per phone
    noise_db: float = -26.0      # additive noise floor vs unit speech
    event_prob: float = 0.35     # chance of a background game-audio event
    # fractional per-utterance pitch drift (bounded random walk across
    # phones).  0.0 keeps utterance pitch static — the default, so the
    # deterministic synthetic-clip soundtrack scheme (io/video) is
    # unchanged; the TRAINING producer sets it >0 so the model cannot
    # lock onto a static harmonic comb (pitch-invariance booster for
    # the holdout-profile extrapolation, VERDICT r3 #3)
    f0_drift: float = 0.0

    @classmethod
    def sample(cls, rng: np.random.Generator) -> "SpeakerProfile":
        """The TRAINING speaker family.

        v2 ranges are domain-randomized wide (the segmenter-v3 playbook:
        v1's 95-215 Hz / 0.92-1.10 / 0.058-0.092 s / −32..−18 dB trained
        to 0.97 base exact but 0.57 CER on holdout speakers) while still
        leaving every holdout dimension an extrapolation: holdout f0
        starts at 235 (train ≤ 225), formant at 0.869/1.148 (train
        0.89-1.13), rate at 0.0515/0.0989 (train 0.054-0.097), noise at
        −17 (train ≤ −17.5)."""
        return cls(
            f0=float(rng.uniform(85.0, 225.0)),
            formant_scale=float(rng.uniform(0.89, 1.13)),
            char_dur=float(rng.uniform(0.054, 0.097)),
            noise_db=float(rng.uniform(-32.0, -17.5)),
        )

    @classmethod
    def sample_holdout(cls, rng: np.random.Generator) -> "SpeakerProfile":
        """Never-trained speaker family: every dimension extrapolates
        past the training range (pitch above, formant scale below/above,
        rate faster or slower, noisier floor)."""
        return cls(
            f0=float(rng.uniform(235.0, 290.0)),
            formant_scale=float(rng.choice([0.86, 1.16])
                                * rng.uniform(0.99, 1.01)),
            char_dur=float(rng.choice([0.050, 0.102])
                           * rng.uniform(0.97, 1.03)),
            noise_db=float(rng.uniform(-17.0, -14.0)),
        )


def _voiced_phone(rng: np.random.Generator, n: int, f0: float,
                  f1: float, f2: float) -> np.ndarray:
    """Harmonic stack with a two-formant spectral envelope.

    Synthesized in the frequency domain (harmonic bumps on an rFFT
    grid → irfft): one O(n log n) transform per phone instead of a
    [n, harmonics] sin matrix — the training producer is host-CPU
    bound, and this is its hot function.  Harmonics land on the
    nearest FFT bin (≤ ±half-bin ≈ 8 Hz detune at 60-100 ms phones),
    which reads as light vocal roughness and changes nothing the mel
    frontend resolves.
    """
    n_bins = n // 2 + 1
    df = SAMPLE_RATE / n
    k = np.arange(1, min(int(3800.0 / f0), 48) + 1)
    freqs = k * f0
    bins = np.round(freqs / df).astype(np.int64)
    valid = bins < n_bins
    bins, freqs, k = bins[valid], freqs[valid], k[valid]
    amps = (np.exp(-((freqs - f1) / 130.0) ** 2)
            + 0.75 * np.exp(-((freqs - f2) / 170.0) ** 2)
            + 0.02 / k)                       # weak spectral tilt floor
    phases = rng.uniform(0, 2 * np.pi, len(bins))
    spec = np.zeros(n_bins, np.complex128)
    np.add.at(spec, bins, amps * np.exp(1j * phases))
    return np.fft.irfft(spec, n).astype(np.float32)


def _noise_phone(rng: np.random.Generator, n: int,
                 center: float, width: float = 420.0) -> np.ndarray:
    """Gaussian band-passed noise burst (fricative-like)."""
    spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.fft.rfftfreq(n, 1.0 / SAMPLE_RATE)
    spec *= np.exp(-((freqs - center) / width) ** 2)
    return np.fft.irfft(spec, n).astype(np.float32)


def synth_speech(rng: np.random.Generator, text: str,
                 profile: Optional[SpeakerProfile] = None,
                 total_seconds: float = 6.0) -> np.ndarray:
    """Render ``text`` as a [total_seconds * 16 kHz] float32 waveform."""
    profile = profile or SpeakerProfile.sample(rng)
    total = int(total_seconds * SAMPLE_RATE)
    xfade = int(0.008 * SAMPLE_RATE)
    ramp = np.linspace(0.0, 1.0, xfade, dtype=np.float32)

    out = np.zeros(total, np.float32)
    pos = int(rng.uniform(0.02, 0.3) * SAMPLE_RATE)   # leading silence
    drift = 0.0
    for ch in text.lower():
        dur = profile.char_dur * float(rng.uniform(0.85, 1.15))
        if ch not in ALPHABET:                        # space / unknown
            pos += int(dur * 0.6 * SAMPLE_RATE)
            continue
        idx = ALPHABET.index(ch)
        n = int(dur * SAMPLE_RATE)
        f1 = float(_F1[idx]) * profile.formant_scale
        f2 = float(_F2[idx]) * profile.formant_scale
        if profile.f0_drift > 0.0:   # bounded random walk, per phone
            drift = float(np.clip(
                drift + rng.normal(0.0, profile.f0_drift / 3.0),
                -profile.f0_drift, profile.f0_drift))
        if _VOICED[idx]:
            phone = _voiced_phone(rng, n, profile.f0 * (1.0 + drift),
                                  f1, f2)
        else:
            phone = _noise_phone(rng, n, f2)
        peak = np.abs(phone).max()
        if peak > 0:
            phone = phone / peak * float(rng.uniform(0.5, 0.9))
        # amplitude envelope + crossfade into the running buffer
        env = np.ones(n, np.float32)
        env[:xfade] = ramp[: min(xfade, n)]
        env[-xfade:] *= ramp[::-1][: min(xfade, n)]
        end = min(pos + n, total)
        if end <= pos:
            break
        out[pos:end] += (phone * env)[: end - pos]
        pos += max(n - xfade, 1)
        if pos >= total - xfade:
            break

    # noise floor
    noise_amp = 10.0 ** (profile.noise_db / 20.0)
    rolloff = float(rng.uniform(0.0, 1.2))
    spec = np.fft.rfft(rng.standard_normal(total))
    freqs = np.maximum(np.fft.rfftfreq(total, 1.0 / SAMPLE_RATE), 1.0)
    spec *= freqs ** (-rolloff / 2)
    noise = np.fft.irfft(spec, total).astype(np.float32)
    noise /= max(np.abs(noise).max(), 1e-9)
    out += noise * noise_amp

    # optional background game-audio event (music chord / impact / beep)
    if rng.random() < profile.event_prob:
        from gvl_tpu_torch.audio.event_model import EventModelConfig, synth_event

        cls = str(rng.choice(["music", "impact", "ui", "ambient"]))
        ev_cfg = EventModelConfig(window_seconds=total / SAMPLE_RATE)
        ev = synth_event(rng, cls, ev_cfg)[:total]
        peak = np.abs(ev).max()
        if peak > 0:
            out += ev / peak * float(rng.uniform(0.03, 0.12))

    peak = np.abs(out).max()
    if peak > 1.0:
        out /= peak
    return out


def asr_config(**kw) -> WhisperConfig:
    """The byte ASR geometry: d_model 256, 4 + 4 layers, 4 heads, 300
    source positions (6 s windows), 96 target positions."""
    base = dict(d_model=256, encoder_layers=4, decoder_layers=4,
                num_heads=4, ffn_dim=1024, num_mel_bins=80,
                max_source_positions=300, max_target_positions=96,
                vocab_size=VOCAB_SIZE,
                decoder_start_token_id=BOS_ID, eos_token_id=EOS_ID)
    base.update(kw)
    return WhisperConfig(**base)


def character_error_rate(ref: str, hyp: str) -> float:
    """Levenshtein distance / len(ref)."""
    if not ref:
        return float(len(hyp) > 0)
    prev = list(range(len(hyp) + 1))
    for i, rc in enumerate(ref, 1):
        cur = [i]
        for j, hc in enumerate(hyp, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (rc != hc)))
        prev = cur
    return prev[-1] / len(ref)


def word_error_rate(ref: str, hyp: str) -> float:
    r, h = ref.split(), hyp.split()
    if not r:
        return float(len(h) > 0)
    prev = list(range(len(h) + 1))
    for i, rw in enumerate(r, 1):
        cur = [i]
        for j, hw in enumerate(h, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (rw != hw)))
        prev = cur
    return prev[-1] / len(r)


def load_asr(ckpt_dir) -> tuple[WhisperConfig, dict]:
    """(config, JAX parameter tree as numpy) of a trained ASR directory."""
    ckpt = Path(ckpt_dir)
    raw = json.loads((ckpt / "asr_config.json").read_text())
    return WhisperConfig(**raw["model"]), load_flat_npz(ckpt / "params.npz")


def is_trained_asr_checkpoint(path) -> bool:
    return bool(path) and (Path(path) / "asr_config.json").exists()


class TrainedByteASR:
    """ASR backend over the trained checkpoint: ``(chunk, sample_rate) ->
    (text, confidence)``.  Long chunks are split into the model's window,
    windows below RMS 1e-4 are skipped (the model never saw digital
    silence), and the pieces are re-joined.

    Each window decodes with :func:`~gvl_tpu_torch.models.whisper.
    greedy_decode_cached` (cross K/V once, one token per step), where the
    JAX backend recomputes the decoder over the whole buffer each step
    (``greedy_decode``, a static shape for ``jit``): the same greedy tokens
    in exact arithmetic, held equal on the trained weights by the tests."""

    def __init__(self, config: WhisperConfig, params: dict,
                 audio_seconds: Optional[float] = None,
                 device: str | torch.device = "cuda"):
        from gvl_tpu_torch.audio.mel import HOP_LENGTH

        self.device = resolve_device(device)
        self.config = config
        if audio_seconds is None:
            # the encoder's window: positions x conv stride 2 x hop samples
            audio_seconds = config.max_source_positions * 2 * HOP_LENGTH / SAMPLE_RATE
        self._window = int(audio_seconds * SAMPLE_RATE)
        self.model = load_whisper(config, params, self.device)

    @classmethod
    def from_dir(cls, ckpt_dir, **kw) -> "TrainedByteASR":
        cfg, params = load_asr(ckpt_dir)
        return cls(cfg, params, **kw)

    def decode_windows(self, wavs: torch.Tensor) -> torch.Tensor:
        """``[N, window]`` waveforms on the card → greedy tokens ``[N, 96]``."""
        from gvl_tpu_torch.audio.mel import log_mel_spectrogram

        prompts = torch.full((wavs.shape[0], 1), BOS_ID, dtype=torch.int64,
                             device=wavs.device)
        return greedy_decode_cached(self.model, log_mel_spectrogram(wavs), prompts,
                                    max_new_tokens=self.config.max_target_positions - 1)

    def _transcribe_window(self, wav: np.ndarray) -> str:
        if len(wav) < self._window:
            wav = np.pad(wav, (0, self._window - len(wav)))
        tokens = self.decode_windows(torch.from_numpy(wav[None]).to(self.device))
        ids = [int(t) for t in tokens[0, 1:].cpu().numpy() if int(t) != EOS_ID]
        return bytes(t for t in ids if t < 256).decode("utf-8", errors="replace").strip()

    def __call__(self, chunk: np.ndarray, sample_rate: int) -> tuple[str, float]:
        wav = np.asarray(chunk, np.float32)
        if sample_rate != SAMPLE_RATE and len(wav):
            n_out = max(int(len(wav) * SAMPLE_RATE / sample_rate), 1)
            wav = np.interp(np.linspace(0, len(wav) - 1, n_out),
                            np.arange(len(wav)), wav).astype(np.float32)
        if not len(wav) or float(np.sqrt((wav ** 2).mean())) < 1e-4:
            return "", 0.0
        pieces = [self._transcribe_window(w)
                  for w in (wav[s:s + self._window]
                            for s in range(0, len(wav), self._window))
                  if float(np.sqrt((w ** 2).mean())) >= 1e-4]
        return " ".join(p for p in pieces if p).strip(), 0.85
