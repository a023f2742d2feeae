"""Audio analysis: ASR and non-speech events over chunked audio (the
port's copy of :mod:`gvl_tpu.audio.processor`).

The host reads WAV (:func:`gvl_tpu_torch.runtime.native.read_wav_native`,
the port's build of the JAX package's native reader), resamples, and cuts 30 s chunks
with 0.5 s overlap; the card classifies 1 s windows with the trained event
net (:class:`~gvl_tpu_torch.audio.event_model.TorchAudioEventDetector`)
and transcribes speech spans with an HF Whisper checkpoint
(:class:`WhisperTorchASR`) or the trained byte ASR
(:class:`~gvl_tpu_torch.training.asr_train.TrainedByteASR`); an HF wav2vec2
checkpoint gives the chunk embeddings (:class:`Wav2Vec2TorchEmbedder`).
Without checkpoints the spectral heuristic and :class:`DeterministicFakeASR`
keep the pipeline running.  Other containers than WAV read as silence with
a warning.
"""

from __future__ import annotations

import hashlib
import logging
import shutil
import subprocess
import tempfile
import wave
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


class AudioEventType(Enum):
    SPEECH = "speech"
    MUSIC = "music"
    EFFECT = "effect"
    AMBIENT = "ambient"
    UI = "ui"
    SILENCE = "silence"


@dataclass
class TranscriptionSegment:
    text: str
    start_time: float
    end_time: float
    confidence: float = 1.0
    speaker_id: Optional[str] = None

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time

    def to_timeline_entry(self) -> str:
        speaker = f"[{self.speaker_id}]" if self.speaker_id else "[Speech]"
        return f'{speaker}: "{self.text}"'


@dataclass
class AudioEvent:
    event_type: AudioEventType
    description: str
    start_time: float
    end_time: float
    confidence: float = 1.0
    intensity: float = 0.5
    metadata: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time

    def to_timeline_entry(self) -> str:
        return f"(Audio: {self.description})"


@dataclass
class AudioAnalysisResult:
    start_time: float
    end_time: float
    transcriptions: list[TranscriptionSegment] = field(default_factory=list)
    events: list[AudioEvent] = field(default_factory=list)
    dominant_type: AudioEventType = AudioEventType.SILENCE

    @property
    def has_speech(self) -> bool:
        return len(self.transcriptions) > 0

    @property
    def has_events(self) -> bool:
        return len(self.events) > 0

    def get_timeline_entries(self) -> list[tuple[float, str]]:
        entries = [
            (seg.start_time, seg.to_timeline_entry())
            for seg in self.transcriptions
        ]
        entries += [(ev.start_time, ev.to_timeline_entry()) for ev in self.events]
        entries.sort(key=lambda x: x[0])
        return entries


@dataclass
class AudioConfig:
    sample_rate: int = 16000
    max_audio_length: float = 30.0  # seconds per chunk
    chunk_overlap: float = 0.5
    enable_transcription: bool = True
    enable_event_detection: bool = True
    silence_rms_threshold: float = 1e-3
    event_energy_threshold: float = 3.0  # x median energy → effect


class AudioPreprocessor:
    """Host-side decode / resample / chunk."""

    def __init__(self, config: Optional[AudioConfig] = None):
        self.config = config or AudioConfig()

    def load_audio(self, path: str | Path) -> tuple[np.ndarray, int]:
        """WAV (the port's reader, then the stdlib's) → zeros.  Returns
        (mono f32, rate)."""
        path = Path(path)
        try:
            if path.suffix.lower() != ".wav":
                raise ValueError("only WAV files are read")
            try:  # 16/24/32-bit and float: the native decoder
                from gvl_tpu_torch.runtime.native import read_wav_native

                return read_wav_native(path)
            except Exception:
                return self._read_wav(path)
        except Exception as exc:
            logger.warning("audio load failed for %s: %s — returning silence",
                           path, exc)
            return np.zeros(self.config.sample_rate, np.float32), self.config.sample_rate

    @staticmethod
    def _read_wav(path: Path) -> tuple[np.ndarray, int]:
        with wave.open(str(path), "rb") as wf:
            rate = wf.getframerate()
            n = wf.getnframes()
            width = wf.getsampwidth()
            channels = wf.getnchannels()
            raw = wf.readframes(n)
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        data = np.frombuffer(raw, dtype=dtype)
        if channels > 1:
            data = data.reshape(-1, channels)
        return AudioPreprocessor._to_mono_f32(data), rate

    @staticmethod
    def _to_mono_f32(data: np.ndarray) -> np.ndarray:
        if data.ndim == 2:
            data = data.mean(axis=1)
        if data.dtype == np.uint8:
            return (data.astype(np.float32) - 128.0) / 128.0
        if np.issubdtype(data.dtype, np.integer):
            return data.astype(np.float32) / float(np.iinfo(data.dtype).max)
        return data.astype(np.float32)

    def resample(self, audio: np.ndarray, rate: int) -> np.ndarray:
        """Polyphase resample to the configured rate."""
        target = self.config.sample_rate
        if rate == target:
            return audio
        from math import gcd

        from gvl_tpu_torch.runtime.wav import resample_poly

        g = gcd(rate, target)
        return resample_poly(audio, target // g, rate // g).astype(np.float32)

    def extract_from_video(self, video_path: str | Path) -> tuple[np.ndarray, int]:
        """ffmpeg demux when present; silence otherwise."""
        if shutil.which("ffmpeg") is None:
            logger.warning("ffmpeg unavailable; cannot demux %s", video_path)
            return np.zeros(self.config.sample_rate, np.float32), self.config.sample_rate
        with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
            cmd = [
                "ffmpeg", "-y", "-i", str(video_path), "-vn",
                "-acodec", "pcm_s16le", "-ar", str(self.config.sample_rate),
                "-ac", "1", tmp.name,
            ]
            subprocess.run(cmd, check=True, capture_output=True)
            return self._read_wav(Path(tmp.name))

    def chunk_audio(
        self,
        audio: np.ndarray,
        sample_rate: int,
        chunk_duration: Optional[float] = None,
        overlap: Optional[float] = None,
    ) -> list[tuple[np.ndarray, float, float]]:
        """Overlapping fixed-length chunks, zero-padded at the tail.

        Returns (chunk, start_time, end_time) with end_time at the real
        (unpadded) end.
        """
        duration = chunk_duration or self.config.max_audio_length
        overlap = self.config.chunk_overlap if overlap is None else overlap
        chunk_n = int(duration * sample_rate)
        stride = chunk_n - int(overlap * sample_rate)
        chunks = []
        pos = 0
        while pos < len(audio):
            end = min(pos + chunk_n, len(audio))
            chunk = audio[pos:end]
            if len(chunk) < chunk_n:
                chunk = np.pad(chunk, (0, chunk_n - len(chunk)))
            chunks.append((chunk, pos / sample_rate, end / sample_rate))
            pos += stride
        return chunks


class AudioEventParser:
    """Keyword classifier: text description → typed audio events."""

    EVENT_KEYWORDS = {
        AudioEventType.MUSIC: ["music", "melody", "song", "tune", "beat", "rhythm"],
        AudioEventType.EFFECT: ["explosion", "crash", "bang", "hit", "impact", "shot"],
        AudioEventType.AMBIENT: ["wind", "rain", "water", "birds", "traffic", "crowd"],
        AudioEventType.UI: ["click", "beep", "notification", "chime", "alert"],
    }

    def parse_description(
        self, description: str, start_time: float, end_time: float
    ) -> list[AudioEvent]:
        desc = description.lower()
        events = []
        for event_type, keywords in self.EVENT_KEYWORDS.items():
            if any(k in desc for k in keywords):
                events.append(
                    AudioEvent(event_type, description, start_time, end_time,
                               confidence=0.8)
                )
        if not events and description and "silence" not in desc:
            events.append(
                AudioEvent(AudioEventType.AMBIENT, description, start_time,
                           end_time, confidence=0.5)
            )
        return events


class DeterministicFakeASR:
    """Hash-seeded ASR stand-in with the same (text, confidence) interface."""

    _WORDS = ("the", "boss", "attack", "watch", "out", "go", "left", "right",
              "heal", "now", "enemy", "down", "nice", "shot", "loot", "run")

    def __call__(self, chunk: np.ndarray, sample_rate: int) -> tuple[str, float]:
        rms = float(np.sqrt(np.mean(chunk ** 2)))
        if rms < 1e-4:
            return "", 0.0
        digest = hashlib.blake2b(chunk[: sample_rate].tobytes(),
                                 digest_size=8).digest()
        rng = np.random.default_rng(int.from_bytes(digest, "little"))
        n_words = int(rng.integers(2, 7))
        return " ".join(rng.choice(self._WORDS, n_words)), 0.5


class WhisperTorchASR:
    """HF Whisper backend (``gvl_tpu.audio.processor.WhisperJaxASR``): the
    chunk's log-mel, then greedy decoding with the cross K/V computed once
    (:func:`~gvl_tpu_torch.models.whisper.greedy_decode_cached`) after the
    ``<|startoftranscript|><|en|><|transcribe|><|notimestamps|>`` prompt,
    on the model's device; text through the HF tokenizer."""

    def __init__(self, model, tokenizer, max_new_tokens: int = 128):
        self.model = model
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.device = next(model.parameters()).device
        prompt = tokenizer.convert_tokens_to_ids(
            ["<|startoftranscript|>", "<|en|>", "<|transcribe|>", "<|notimestamps|>"])
        self._prompt = torch.tensor([prompt], dtype=torch.int64, device=self.device)
        self._eos = model.config.eos_token_id

    def decode(self, chunk: np.ndarray) -> torch.Tensor:
        """Greedy tokens ``[1, 4 + max_new_tokens]`` of one chunk."""
        from gvl_tpu_torch.audio.mel import log_mel_spectrogram
        from gvl_tpu_torch.models.whisper import greedy_decode_cached

        wav = torch.from_numpy(np.asarray(chunk, np.float32)).to(self.device)
        return greedy_decode_cached(self.model, log_mel_spectrogram(wav)[None],
                                    self._prompt, max_new_tokens=self.max_new_tokens)

    def __call__(self, chunk: np.ndarray, sample_rate: int) -> tuple[str, float]:
        tokens = self.decode(chunk)[0, self._prompt.shape[1]:].cpu().numpy()
        text_ids = [int(t) for t in tokens if t != self._eos]
        return self.tokenizer.decode(text_ids, skip_special_tokens=True).strip(), 0.9


class AudioProcessor:
    """Dual-mode audio analysis: ASR + event detection.

    >>> proc = AudioProcessor()        # fake ASR, heuristic events
    >>> result = proc.analyze_audio(wav, 16000)
    >>> result.transcriptions, result.events
    """

    def __init__(
        self,
        config: Optional[AudioConfig] = None,
        asr_backend: Optional[Callable] = None,
        event_backend: Optional[Callable] = None,
    ):
        self.config = config or AudioConfig()
        self.preprocessor = AudioPreprocessor(self.config)
        self.event_parser = AudioEventParser()
        self.asr = asr_backend or DeterministicFakeASR()
        # trained TorchAudioEventDetector when a checkpoint resolves;
        # None → the spectral heuristic rung below
        self.event_backend = event_backend

    # ---------------------------------------------------------------- ASR

    def transcribe(
        self, audio: np.ndarray, sample_rate: int, offset: float = 0.0
    ) -> list[TranscriptionSegment]:
        segments = []
        for chunk, start, end in self.preprocessor.chunk_audio(audio, sample_rate):
            text, conf = self.asr(chunk, sample_rate)
            if text:
                segments.append(
                    TranscriptionSegment(
                        text=text,
                        start_time=offset + start,
                        end_time=offset + end,
                        confidence=conf,
                    )
                )
        return segments

    # -------------------------------------------------------- event detect

    def detect_audio_events(
        self, audio: np.ndarray, sample_rate: int, offset: float = 0.0
    ) -> list[AudioEvent]:
        """Events over 1 s windows: trained model when available, else
        the spectral heuristic.

        Top rung (``event_backend``): a
        :class:`~gvl_tpu_torch.audio.event_model.TorchAudioEventDetector`
        classifies every window in one forward on the card.  Fallback rung: loud
        wideband transients → "impact sound" (EFFECT); sustained tonal
        energy → "background music" (MUSIC); moderate noise →
        "ambient noise" (AMBIENT).
        """
        if self.event_backend is not None:
            return self._detect_events_model(audio, sample_rate, offset)
        win = sample_rate
        events: list[AudioEvent] = []
        n = len(audio) // win
        if n == 0:
            return events
        frames = audio[: n * win].reshape(n, win)
        rms = np.sqrt((frames ** 2).mean(axis=1))
        median = max(float(np.median(rms)), 1e-8)

        spectra = np.abs(np.fft.rfft(frames, axis=1))
        centroid = (
            spectra * np.arange(spectra.shape[1])[None, :]
        ).sum(axis=1) / np.maximum(spectra.sum(axis=1), 1e-8)
        flatness = np.exp(
            np.mean(np.log(np.maximum(spectra, 1e-10)), axis=1)
        ) / np.maximum(spectra.mean(axis=1), 1e-10)

        for i in range(n):
            t0, t1 = offset + i, offset + i + 1
            loudness = float(np.clip(rms[i] / (4 * median), 0, 1))
            if rms[i] < self.config.silence_rms_threshold:
                continue
            if rms[i] > self.config.event_energy_threshold * median:
                events.append(AudioEvent(
                    AudioEventType.EFFECT, "loud impact sound", t0, t1,
                    confidence=0.7, intensity=loudness,
                ))
            elif flatness[i] < 0.1 and centroid[i] > 10:
                events.append(AudioEvent(
                    AudioEventType.MUSIC, "background music", t0, t1,
                    confidence=0.6, intensity=loudness,
                ))
            elif rms[i] > 2 * median:
                events.append(AudioEvent(
                    AudioEventType.AMBIENT, "ambient noise", t0, t1,
                    confidence=0.5, intensity=loudness,
                ))
        return self._merge_adjacent(events)

    def _detect_events_model(
        self, audio: np.ndarray, sample_rate: int, offset: float
    ) -> list[AudioEvent]:
        """Trained-classifier path: every 1 s window is classified in one
        device dispatch; SILENCE windows emit nothing; speech windows
        emit SPEECH events (the ASR path transcribes independently)."""
        from gvl_tpu_torch.audio.event_model import CLASS_DESCRIPTIONS

        win = sample_rate
        n = len(audio) // win
        if n == 0:
            return []
        frames = audio[: n * win].reshape(n, win)
        rms = np.sqrt((frames ** 2).mean(axis=1))
        median = max(float(np.median(rms)), 1e-8)
        labels = self.event_backend(audio, sample_rate)
        type_map = {
            "speech": AudioEventType.SPEECH,
            "music": AudioEventType.MUSIC,
            "impact": AudioEventType.EFFECT,
            "ui": AudioEventType.UI,
            "ambient": AudioEventType.AMBIENT,
        }
        events: list[AudioEvent] = []
        for i, (cls, conf) in enumerate(labels[:n]):
            if cls == "silence" or cls not in type_map:
                continue
            if rms[i] < self.config.silence_rms_threshold:
                continue
            events.append(AudioEvent(
                type_map[cls], CLASS_DESCRIPTIONS[cls],
                offset + i, offset + i + 1,
                confidence=float(conf),
                intensity=float(np.clip(rms[i] / (4 * median), 0, 1)),
            ))
        return self._merge_adjacent(events)

    @staticmethod
    def _merge_adjacent(events: list[AudioEvent]) -> list[AudioEvent]:
        """Collapse runs of same-type events into spans."""
        merged: list[AudioEvent] = []
        for ev in events:
            if (
                merged
                and merged[-1].event_type is ev.event_type
                and abs(merged[-1].end_time - ev.start_time) < 1e-6
            ):
                merged[-1].end_time = ev.end_time
                merged[-1].intensity = max(merged[-1].intensity, ev.intensity)
            else:
                merged.append(ev)
        return merged

    # ------------------------------------------------------------- analyze

    def analyze_audio(
        self, audio: np.ndarray, sample_rate: int, offset: float = 0.0
    ) -> AudioAnalysisResult:
        if sample_rate != self.config.sample_rate:
            audio = self.preprocessor.resample(audio, sample_rate)
            sample_rate = self.config.sample_rate
        result = AudioAnalysisResult(
            start_time=offset, end_time=offset + len(audio) / sample_rate
        )
        if self.config.enable_event_detection:
            result.events = self.detect_audio_events(audio, sample_rate, offset)
        if self.config.enable_transcription:
            # event-gated transcription: with a trained event classifier
            # the ASR runs only on speech-classified spans (decoding
            # music/impact windows produces garbage text); full chunking
            # remains the no-classifier fallback
            spans = (self._speech_spans(result.events, offset)
                     if self.event_backend is not None else None)
            if spans is None:
                result.transcriptions = self.transcribe(
                    audio, sample_rate, offset)
            else:
                result.transcriptions = []
                for t0, t1 in spans:
                    s0 = max(0, int((t0 - offset) * sample_rate))
                    s1 = min(len(audio), int((t1 - offset) * sample_rate))
                    if s1 <= s0:
                        continue
                    result.transcriptions.extend(self.transcribe(
                        audio[s0:s1], sample_rate, offset + s0 / sample_rate))
        result.dominant_type = self._dominant(result)
        return result

    @staticmethod
    def _speech_spans(events, offset: float,
                      pad: float = 0.5) -> list[tuple[float, float]]:
        """Merged (start, end) spans of SPEECH-classified events, padded
        ``pad`` seconds each side (window quantization slack)."""
        spans = sorted(
            (ev.start_time - pad, ev.end_time + pad)
            for ev in events if ev.event_type is AudioEventType.SPEECH)
        merged: list[tuple[float, float]] = []
        for t0, t1 in spans:
            if merged and t0 <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
            else:
                merged.append((t0, t1))
        return merged

    def analyze_video_audio(self, video_path: str | Path) -> AudioAnalysisResult:
        audio, rate = self.preprocessor.extract_from_video(video_path)
        return self.analyze_audio(audio, rate)

    @staticmethod
    def _dominant(result: AudioAnalysisResult) -> AudioEventType:
        if result.has_speech:
            return AudioEventType.SPEECH
        if result.events:
            counts: dict[AudioEventType, float] = {}
            for ev in result.events:
                counts[ev.event_type] = counts.get(ev.event_type, 0) + ev.duration
            return max(counts, key=counts.get)
        return AudioEventType.SILENCE


class HashAudioEmbedder:
    """Deterministic fake wav2vec2-style chunk embedder (1024-dim)."""

    def __init__(self, dim: int = 1024):
        self.dim = dim

    def __call__(self, chunk: np.ndarray, sample_rate: int) -> np.ndarray:
        digest = hashlib.blake2b(chunk.tobytes(), digest_size=8).digest()
        rng = np.random.default_rng(int.from_bytes(digest, "little"))
        return rng.standard_normal(self.dim).astype(np.float32)


class Wav2Vec2TorchEmbedder:
    """wav2vec2 chunk embeddings (``gvl_tpu.audio.processor.
    Wav2Vec2JaxEmbedder``): each chunk zero-padded (or cut) to a fixed bucket
    of ``chunk_seconds`` at ``sample_rate``, one f32 forward on the
    encoder's device, the last hidden state mean-pooled there; only the
    ``[hidden]`` vector comes back."""

    def __init__(self, encoder, chunk_seconds: float = 10.0, sample_rate: int = 16000):
        self.encoder = encoder
        self.dim = encoder.config.hidden_size
        self.device = next(encoder.parameters()).device
        self._bucket = int(chunk_seconds * sample_rate)

    @torch.inference_mode()
    def __call__(self, chunk: np.ndarray, sample_rate: int) -> np.ndarray:
        wav = np.asarray(chunk, np.float32)
        if len(wav) < self._bucket:
            wav = np.pad(wav, (0, self._bucket - len(wav)))
        else:
            wav = wav[: self._bucket]
        out = self.encoder(torch.from_numpy(wav[None]).to(self.device))
        return out["last_hidden_state"][0].mean(0).float().cpu().numpy()


def create_audio_processor(
    whisper_checkpoint: Optional[str] = None,
    config: Optional[AudioConfig] = None,
    event_checkpoint: Optional[str] = None,
    asr_checkpoint: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> AudioProcessor:
    """Factory: the best rung of the ASR ladder plus the trained event
    classifier when its checkpoint resolves, both on ``device``.

    ASR ladder: ``whisper_checkpoint`` (an HF Whisper directory:
    :class:`WhisperTorchASR`, its tokenizer ``transformers.WhisperTokenizer``
    imported here only) → ``asr_checkpoint`` (the trained byte ASR) → the
    deterministic fake."""
    asr_backend = None
    if whisper_checkpoint and Path(whisper_checkpoint).exists():
        from transformers import WhisperTokenizer

        from gvl_tpu_torch.models.whisper import load_hf_whisper, load_whisper

        config, state = load_hf_whisper(whisper_checkpoint)
        tokenizer = WhisperTokenizer.from_pretrained(whisper_checkpoint)
        asr_backend = WhisperTorchASR(load_whisper(config, state, device), tokenizer)
    if asr_backend is None and asr_checkpoint:
        from gvl_tpu_torch.training.asr_train import TrainedByteASR, is_trained_asr_checkpoint

        if is_trained_asr_checkpoint(asr_checkpoint):
            asr_backend = TrainedByteASR.from_dir(asr_checkpoint, device=device)
            logger.info("audio ASR: self-trained byte ASR from %s", asr_checkpoint)
    event_backend = None
    if event_checkpoint and Path(event_checkpoint).exists():
        from gvl_tpu_torch.audio.event_model import TorchAudioEventDetector, load_event_params

        event_backend = TorchAudioEventDetector(load_event_params(event_checkpoint),
                                                device=device)
        logger.info("audio events: trained classifier from %s", event_checkpoint)
    return AudioProcessor(config, asr_backend=asr_backend, event_backend=event_backend)


def build_audio_stack(preset_audio, device: str | torch.device = "cuda"
                      ) -> tuple[AudioProcessor, Callable]:
    """(processor, chunk_embedder) from the preset's checkpoint ladder
    (``gvl_tpu.audio.processor.build_audio_stack``; ``preset_audio`` is the
    :class:`gvl_tpu_torch.config.presets.AudioConfig` section), its models
    on ``device``: ASR ``whisper_checkpoint`` (HF Whisper,
    :class:`WhisperTorchASR`) > ``asr_checkpoint`` (the trained byte ASR) >
    the deterministic fake; events from ``event_checkpoint`` when it
    resolves.  Chunk embeddings, while ``use_wav2vec`` is on (as in JAX):
    ``wav2vec2_checkpoint`` (HF wav2vec2, :class:`Wav2Vec2TorchEmbedder`
    over ``wav2vec2_chunk_seconds`` buckets) > the event net's pooled
    features (with ``event_checkpoint``); :class:`HashAudioEmbedder`
    otherwise."""
    from gvl_tpu_torch.utils.checkpoints import resolve_repo_path

    config = AudioConfig(sample_rate=getattr(preset_audio, "sample_rate", 16000))
    whisper_dir = resolve_repo_path(getattr(preset_audio, "whisper_checkpoint", None))
    event_ckpt = resolve_repo_path(getattr(preset_audio, "event_checkpoint", None))
    asr_ckpt = resolve_repo_path(getattr(preset_audio, "asr_checkpoint", None))
    processor = create_audio_processor(whisper_dir, config, event_checkpoint=event_ckpt,
                                       asr_checkpoint=asr_ckpt, device=device)
    if whisper_dir:
        logger.info("audio ASR: HF Whisper from %s", whisper_dir)
    embedder: Callable = HashAudioEmbedder(1024)
    if getattr(preset_audio, "use_wav2vec", True):
        w2v_dir = resolve_repo_path(getattr(preset_audio, "wav2vec2_checkpoint", None))
        if w2v_dir:
            from gvl_tpu_torch.models.wav2vec2 import load_hf_wav2vec2, load_wav2vec2

            w2v_config, state = load_hf_wav2vec2(w2v_dir)
            embedder = Wav2Vec2TorchEmbedder(
                load_wav2vec2(w2v_config, state, device),
                chunk_seconds=getattr(preset_audio, "wav2vec2_chunk_seconds", 10.0),
                sample_rate=config.sample_rate)
            logger.info("audio embeddings: HF wav2vec2 from %s", w2v_dir)
        elif event_ckpt:
            from gvl_tpu_torch.audio.event_model import TrainedAudioEmbedder

            embedder = TrainedAudioEmbedder.from_checkpoint(event_ckpt, device=device)
            logger.info("audio embeddings: trained event-model features from %s", event_ckpt)
    return processor, embedder
