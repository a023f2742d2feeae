"""The self-trained byte-level ASR model, inference only (the port's copy of
the inference half of :mod:`gvl_tpu.training.asr_train`).

A ~10M-parameter Whisper geometry (:mod:`gvl_tpu_torch.models.whisper`)
over the byte vocabulary: 6 s windows (600 mel frames, 300 encoder
positions), greedy decode of up to 95 bytes.  Speech synthesis and the
trainer stay in the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.byte_tokenizer import BOS_ID, EOS_ID, VOCAB_SIZE
from gvl_tpu_torch.models.whisper import WhisperConfig, greedy_decode_cached, load_whisper
from gvl_tpu_torch.utils.checkpoints import load_flat_npz

SAMPLE_RATE = 16000


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
