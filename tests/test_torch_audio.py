"""gvl_tpu_torch's audio stack against gvl_tpu's, on the CPU: the log-mel
frontend, the trained event classifier (``outputs/audio_event_params.npz``),
the Whisper model (``WhisperConfig.tiny_random`` with JAX-initialised
weights, and the trained byte ASR in ``outputs/asr``), the WAV reader and
resampler, and ``AudioProcessor``.

Tolerances: log-mel within 1e-4 (``log10`` of f32 power sums over 400-point
FFTs); event probabilities and embeddings within 1e-5; Whisper encoder
states and logits within 1e-4 (a 1e-5 bound holds where no reduction is
longer than 1024 and values stay below 1: the tiny model's states);
decoded tokens, transcripts, events, segments and WAV samples exactly
equal; the resampler within 1e-6 of scipy (f32 output of a float64
filter).  The utterances are ``gvl_tpu``'s own ``synth_speech``; the port
does not copy the generator.
"""

import math
import struct
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly as scipy_resample_poly

from gvl_tpu.audio import event_model as jev
from gvl_tpu.audio import mel as jmel
from gvl_tpu.audio import processor as jproc
from gvl_tpu.models import whisper as jw
from gvl_tpu.runtime.native import read_wav_native
from gvl_tpu.training import asr_train as jasr
from gvl_tpu_torch.audio import event_model as tev
from gvl_tpu_torch.audio import mel as tmel
from gvl_tpu_torch.audio import processor as tproc
from gvl_tpu_torch.models import whisper as tw
from gvl_tpu_torch.runtime.wav import read_wav, resample_poly
from gvl_tpu_torch.training import asr_train as tasr

REPO = Path(__file__).resolve().parents[1]
EVENT_CKPT = REPO / "outputs" / "audio_event_params.npz"
ASR_CKPT = REPO / "outputs" / "asr"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side in one thread: these tests run many small ops (a
    decode step, one query), which thread pools shared with the suite's
    other workers slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_config(cfg):
    return tw.WhisperConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


def _soundtrack(seed=0):
    """Speech, music, an impact, silence, UI chimes and more speech, each a
    whole number of seconds of ``gvl_tpu``'s procedural audio."""
    rng = np.random.default_rng(seed)
    cfg = jev.EventModelConfig()
    parts = [jasr.synth_speech(rng, "enemy ahead take cover", total_seconds=3.0)]
    for cls in ("music", "music", "impact", "silence", "ui"):
        parts.append(jev.synth_event(rng, cls, cfg))
    parts.append(jasr.synth_speech(rng, "go left now", total_seconds=2.0))
    return np.concatenate(parts).astype(np.float32)


def test_log_mel_matches_jax():
    wav = np.random.default_rng(0).normal(0, 0.1, (3, 24000)).astype(np.float32)
    want = np.asarray(jmel.log_mel_spectrogram(wav))
    np.testing.assert_allclose(tmel.log_mel_spectrogram(torch.from_numpy(wav)).numpy(), want,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tmel.log_mel_spectrogram(wav[0]).numpy(), want[0], atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(tmel.log_mel_numpy(wav), jmel.log_mel_numpy(wav))
    np.testing.assert_array_equal(tmel.mel_filterbank(), jmel.mel_filterbank())


def test_event_probabilities_and_embeddings_match_jax():
    params = jev.load_event_params(EVENT_CKPT)
    audio = _soundtrack()
    n = len(audio) // 16000
    wavs = audio[: n * 16000].reshape(n, 16000)
    model = jev.AudioEventNet(jev.EventModelConfig())
    mel, log_rms = jev._features(jnp.asarray(wavs))
    want = np.asarray(jax.nn.softmax(model.apply(params, mel, log_rms)))
    port = tev.TorchAudioEventDetector(params, device="cpu")
    np.testing.assert_allclose(port.probabilities(torch.from_numpy(wavs)).numpy(), want,
                               atol=1e-5, rtol=0)
    got_labels = port(audio, 16000)
    assert [c for c, _ in got_labels] == [c for c, _ in jev.JaxAudioEventDetector(params)(
        audio, 16000)]
    assert {c for c, _ in got_labels} >= {"speech", "music", "impact", "silence", "ui"}
    want_emb = jev.TrainedAudioEmbedder(params)(audio[:40000], 22050)
    got_emb = tev.TrainedAudioEmbedder(params, device="cpu")(audio[:40000], 22050)
    np.testing.assert_allclose(got_emb, want_emb, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def tiny_whisper():
    cfg = jw.WhisperConfig.tiny_random()
    model = jw.WhisperModel(cfg)
    rng = np.random.default_rng(0)
    mel = rng.normal(0, 1, (2, 40, cfg.num_mel_bins)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(mel),
                                    jnp.asarray(tokens))
    port = tw.load_whisper(_port_config(cfg), jax.tree.map(np.asarray, variables["params"]),
                           "cpu")
    return cfg, model, variables, port, mel, tokens


def test_tiny_whisper_states_and_logits_match_jax(tiny_whisper):
    cfg, model, variables, port, mel, tokens = tiny_whisper
    states = jax.jit(lambda v, m: model.apply(v, m, method=jw.WhisperModel.encode))(
        variables, jnp.asarray(mel))
    logits = jax.jit(model.apply)(variables, jnp.asarray(mel), jnp.asarray(tokens))
    with torch.no_grad():
        got_states = port.encoder(torch.from_numpy(mel))
        got_logits = port(torch.from_numpy(mel), torch.from_numpy(tokens))
    np.testing.assert_allclose(got_states.numpy(), np.asarray(states), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), atol=1e-4, rtol=0)
    # one cached decode step at position 0 against the teacher-forced row 0
    d_head = cfg.d_model // cfg.num_heads
    cross = model.apply(variables, states, method=jw.WhisperModel.precompute_cross)
    caches = [(jnp.zeros((2, cfg.num_heads, 8, d_head)),) * 2
              for _ in range(cfg.decoder_layers)]
    want_step, _ = jax.jit(lambda v, t, c, k: model.apply(
        v, t, c, k, 0, method=jw.WhisperModel.decode_step))(
        variables, jnp.asarray(tokens[:, 0]), cross, caches)
    with torch.no_grad():
        t_cross = port.decoder.precompute_cross(got_states)
        t_caches = [tuple(torch.zeros(2, cfg.num_heads, 8, d_head) for _ in range(2))
                    for _ in range(cfg.decoder_layers)]
        got_step = port.decoder.decode_step(torch.from_numpy(tokens[:, 0]), t_cross,
                                            t_caches, 0)
    np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step), atol=1e-4, rtol=0)


def test_tiny_whisper_greedy_streams_equal(tiny_whisper):
    cfg, model, variables, port, mel, _ = tiny_whisper
    prompt = np.array([[5, 9], [7, 3]], np.int32)
    want = np.asarray(jw.greedy_decode_cached(model, variables, jnp.asarray(mel),
                                              jnp.asarray(prompt), max_new_tokens=12))
    for decode in (tw.greedy_decode, tw.greedy_decode_cached):
        got = decode(port, torch.from_numpy(mel), torch.from_numpy(prompt), 12)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def trained_asr():
    return (jasr.TrainedByteASR.from_dir(ASR_CKPT),
            tasr.TrainedByteASR.from_dir(ASR_CKPT, device="cpu"))


def test_trained_asr_states_and_first_step_match_jax(trained_asr):
    jax_asr, port = trained_asr
    cfg, params = jasr.load_asr(ASR_CKPT)
    wav = jasr.synth_speech(np.random.default_rng(1), "watch out")[:96000]
    mel = np.asarray(jmel.log_mel_spectrogram(wav[None]))
    model = jw.WhisperModel(cfg)

    @jax.jit
    def run(v, mel):
        states = model.apply(v, mel, method=jw.WhisperModel.encode)
        return states, model.apply(v, jnp.full((1, 1), jasr.BOS_ID, jnp.int32), states,
                                   method=jw.WhisperModel.decode)

    states, logits = run({"params": params}, jnp.asarray(mel))
    with torch.no_grad():
        got_states = port.model.encoder(torch.from_numpy(mel))
        got_logits = port.model.decoder(torch.full((1, 1), tasr.BOS_ID), got_states)
    np.testing.assert_allclose(got_states.numpy(), np.asarray(states), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), atol=1e-4, rtol=0)


def test_trained_asr_transcripts_equal_to_jax(trained_asr):
    jax_asr, port = trained_asr
    rng = np.random.default_rng(2026)
    texts = [jasr.sample_utterance(rng) for _ in range(5)]
    wavs = [jasr.synth_speech(rng, t) for t in texts]
    wavs.append(np.concatenate([wavs[0], wavs[1][:40000]]))    # two windows
    got = [port(w, 16000) for w in wavs]
    want = [jax_asr(w, 16000) for w in wavs]
    assert got == want
    assert sum(tasr.character_error_rate(t, g[0]) for t, g in zip(texts, got)) / 5 < 0.5
    assert port(np.zeros(16000, np.float32), 16000) == ("", 0.0)


def test_error_rates_equal():
    pairs = [("enemy ahead", "enemy ahed"), ("", "x"), ("", ""), ("go left now", "go now"),
             ("abc", "")]
    for ref, hyp in pairs:
        assert tasr.character_error_rate(ref, hyp) == jasr.character_error_rate(ref, hyp)
        assert tasr.word_error_rate(ref, hyp) == jasr.word_error_rate(ref, hyp)


def _analysis(result):
    return (result.start_time, result.end_time, result.dominant_type.value,
            [(s.text, s.start_time, s.end_time, s.confidence) for s in result.transcriptions],
            [(e.event_type.value, e.description, e.start_time, e.end_time,
              round(e.confidence, 5), round(e.intensity, 6)) for e in result.events],
            result.get_timeline_entries())


@pytest.mark.parametrize("stack", ["trained", "fakes"])
def test_audio_processor_results_equal(trained_asr, stack):
    audio = _soundtrack(seed=3)
    if stack == "trained":
        params = jev.load_event_params(EVENT_CKPT)
        jax_asr, port_asr = trained_asr
        want_proc = jproc.AudioProcessor(asr_backend=jax_asr,
                                         event_backend=jev.JaxAudioEventDetector(params))
        got_proc = tproc.AudioProcessor(
            asr_backend=port_asr, event_backend=tev.TorchAudioEventDetector(params, device="cpu"))
    else:
        want_proc, got_proc = jproc.AudioProcessor(), tproc.AudioProcessor()
    want = _analysis(want_proc.analyze_audio(audio, 16000, offset=12.0))
    got = _analysis(got_proc.analyze_audio(audio, 16000, offset=12.0))
    assert got == want
    assert want[4] and (want[3] or stack == "fakes")


def test_create_audio_processor_takes_the_same_rungs(monkeypatch):
    made = {}
    monkeypatch.setattr(tasr.TrainedByteASR, "from_dir",
                        classmethod(lambda cls, d, **kw: made.setdefault("asr", d)))
    proc = tproc.create_audio_processor(None, event_checkpoint=str(EVENT_CKPT),
                                        asr_checkpoint=str(ASR_CKPT), device="cpu")
    assert made["asr"] == str(ASR_CKPT)
    assert isinstance(proc.event_backend, tev.TorchAudioEventDetector)
    assert isinstance(tproc.create_audio_processor(None, device="cpu").asr,
                      tproc.DeterministicFakeASR)
    # a Whisper directory reaches the HF Whisper rung (ROADMAP A10, ported):
    # the byte ASR's directory is none, and fails as under JAX's loader
    # (HF directories that load: tests/test_torch_hf_encoders.py)
    with pytest.raises(OSError) as want:
        jproc.create_audio_processor(str(ASR_CKPT))
    with pytest.raises(OSError) as got:
        tproc.create_audio_processor(str(ASR_CKPT), device="cpu")
    assert str(got.value) == str(want.value)


def _write_wav(path, samples: np.ndarray, width: int, rate: int, fmt: int = 1):
    """A RIFF/WAVE file with ``fmt`` 1 (PCM) or 3 (float), a LIST chunk
    before ``data``; samples ``[frames, channels]`` already in the file's
    type."""
    frames, channels = samples.shape
    data = samples.tobytes() if width != 3 else b"".join(
        int(v).to_bytes(3, "little", signed=True) for v in samples.reshape(-1))
    fmt_chunk = struct.pack("<HHIIHH", fmt, channels, rate, rate * channels * width,
                            channels * width, 8 * width)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_chunk
            + b"LIST" + struct.pack("<I", 5) + b"abcde\x00"
            + b"data" + struct.pack("<I", len(data)) + data)
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("width,fmt,channels", [(2, 1, 1), (2, 1, 2), (3, 1, 2), (4, 1, 1),
                                                (4, 3, 2), (3, 1, 5)])
def test_read_wav_equal_to_native(tmp_path, width, fmt, channels):
    rng = np.random.default_rng(width * 10 + channels)
    if fmt == 3:
        samples = rng.normal(0, 0.5, (300, channels)).astype("<f4")
    else:
        lim = 2 ** (8 * width - 1)
        samples = rng.integers(-lim, lim, (300, channels))
        samples = samples.astype({2: "<i2", 3: np.int64, 4: "<i4"}[width])
    path = tmp_path / "a.wav"
    _write_wav(path, samples, width, 22050, fmt)
    got, want = read_wav(path), read_wav_native(path)
    assert got[1] == want[1] == 22050
    assert got[0].dtype == want[0].dtype and got[0].tobytes() == want[0].tobytes()
    assert tproc.AudioPreprocessor().load_audio(path)[0].tobytes() == \
        jproc.AudioPreprocessor().load_audio(path)[0].tobytes()


def test_stdlib_wav_and_chunks_equal(tmp_path):
    path = tmp_path / "b.wav"
    pcm = (np.random.default_rng(0).normal(0, 0.2, 40000) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    got = tproc.AudioPreprocessor._read_wav(path)
    want = jproc.AudioPreprocessor._read_wav(path)
    assert got[1] == want[1] and got[0].tobytes() == want[0].tobytes()
    chunks = [tproc.AudioPreprocessor().chunk_audio(got[0], 16000, 1.0, 0.25),
              jproc.AudioPreprocessor().chunk_audio(got[0], 16000, 1.0, 0.25)]
    assert [(s, e) for _, s, e in chunks[0]] == [(s, e) for _, s, e in chunks[1]]
    assert all(a.tobytes() == b.tobytes() for (a, _, _), (b, _, _) in zip(*chunks))


@pytest.mark.parametrize("rate", [8000, 22050, 44100, 48000])
def test_resample_matches_scipy(rate):
    x = np.random.default_rng(rate).normal(0, 0.3, 30011).astype(np.float32)
    g = math.gcd(rate, 16000)
    want = scipy_resample_poly(x, 16000 // g, rate // g)
    got = resample_poly(x, 16000 // g, rate // g)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
