"""gvl_tpu_torch's wav2vec2 encoder against gvl_tpu's and HF ``Wav2Vec2Model``.

A tiny random ``Wav2Vec2Model`` (the geometry of ``tests/test_encoders.py``)
in both its forms, stable (layer norms, pre-norm layers) and post-norm
(group norm), goes through JAX's ``convert_hf_wav2vec2`` and the port's.
Port against JAX: f32, within 1e-5 of the largest magnitude; port against
``transformers``: within 1e-4.  Then the chunk embedder against
``Wav2Vec2JaxEmbedder`` and the wav2vec2 rung of ``build_audio_stack`` on a
saved directory.
"""

import os

os.environ.setdefault("USE_TF", "0")
os.environ["HF_HUB_OFFLINE"] = "1"
os.environ["TRANSFORMERS_OFFLINE"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gvl_tpu.models import wav2vec2 as jax_w2v  # noqa: E402
from gvl_tpu_torch.models import wav2vec2  # noqa: E402

JAX_SHARE = 1e-5
HF_SHARE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_share(got, want, share):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= share * np.abs(want).max(), (err, np.abs(want).max())


def hf_model(stable: bool):
    from transformers import Wav2Vec2Config, Wav2Vec2Model

    cfg = Wav2Vec2Config(
        hidden_size=32, intermediate_size=64, num_hidden_layers=1,
        num_attention_heads=2, conv_dim=(16, 16), conv_stride=(5, 2),
        conv_kernel=(10, 3), num_feat_extract_layers=2, conv_bias=False,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        do_stable_layer_norm=stable, feat_extract_norm="layer" if stable else "group")
    torch.manual_seed(0)
    return Wav2Vec2Model(cfg).eval()


@pytest.fixture(scope="module", params=[True, False], ids=["stable", "post_norm"])
def pair(request):
    stable = request.param
    hf = hf_model(stable)
    sd = hf.state_dict()
    cfg = wav2vec2.hf_wav2vec2_config(hf.config)
    assert cfg == wav2vec2.Wav2Vec2Config.tiny(stable=stable)
    port = wav2vec2.load_wav2vec2(cfg, wav2vec2.convert_hf_wav2vec2(sd, cfg), device="cpu")
    jcfg = jax_w2v.Wav2Vec2Config.tiny(stable=stable)
    jvars = {"params": jax_w2v.convert_hf_wav2vec2(sd, jcfg)}
    return hf, port, jax_w2v.Wav2Vec2Encoder(jcfg), jvars


def test_encoder_matches_jax_and_hf(pair):
    hf, port, jenc, jvars = pair
    wav = np.random.RandomState(0).randn(2, 800).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(wav))
        ref = hf(input_values=torch.from_numpy(wav))
    want = jax.jit(jenc.apply)(jvars, jnp.asarray(wav))
    assert got["last_hidden_state"].shape == (2, 79, 32)
    for key in ("last_hidden_state", "features"):
        assert_share(got[key].numpy(), np.asarray(want[key]), JAX_SHARE)
    assert_share(got["last_hidden_state"].numpy(), ref.last_hidden_state.numpy(), HF_SHARE)
    with torch.no_grad():    # HF's extract_features are the normed features
        normed = port.proj_norm(got["features"]).numpy()
    assert_share(normed, ref.extract_features.numpy(), HF_SHARE)


def test_frame_count_formula():
    cfg = wav2vec2.Wav2Vec2Config.large()
    assert cfg.frames_for_samples(160000) == 499      # a 10 s chunk at 16 kHz
    assert wav2vec2.Wav2Vec2Config.tiny().frames_for_samples(800) == 79


def test_chunk_embedder_matches_jax(pair):
    from gvl_tpu.audio.processor import Wav2Vec2JaxEmbedder
    from gvl_tpu_torch.audio.processor import Wav2Vec2TorchEmbedder

    _, port, jenc, jvars = pair
    got_emb = Wav2Vec2TorchEmbedder(port, chunk_seconds=0.05, sample_rate=16000)
    want_emb = Wav2Vec2JaxEmbedder(jenc, jvars, chunk_seconds=0.05, sample_rate=16000)
    rng = np.random.default_rng(0)
    for n in (500, 800, 1300):          # padded, exact, cut to the bucket
        chunk = rng.standard_normal(n).astype(np.float32)
        got = got_emb(chunk, 16000)
        assert got.shape == (32,) and got.dtype == np.float32
        assert_share(got, want_emb(chunk, 16000), JAX_SHARE)


@pytest.fixture(scope="module")
def wav2vec2_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wav2vec2")
    hf_model(False).save_pretrained(d)
    return str(d)


def test_build_audio_stack_wav2vec2_rung_matches_jax(wav2vec2_dir):
    from gvl_tpu.audio import build_audio_stack as jax_build
    from gvl_tpu.config import load_preset as jax_preset
    from gvl_tpu_torch.audio.processor import (
        HashAudioEmbedder,
        Wav2Vec2TorchEmbedder,
        build_audio_stack,
    )
    from gvl_tpu_torch.config import load_preset

    configs = [load_preset("standard"), jax_preset("standard")]
    for cfg in configs:
        cfg.audio.wav2vec2_checkpoint = wav2vec2_dir
        cfg.audio.wav2vec2_chunk_seconds = 0.05
        cfg.audio.event_checkpoint = cfg.audio.asr_checkpoint = None
    _, got_emb = build_audio_stack(configs[0].audio, device="cpu")
    _, want_emb = jax_build(configs[1].audio)
    assert isinstance(got_emb, Wav2Vec2TorchEmbedder)
    assert type(want_emb).__name__ == "Wav2Vec2JaxEmbedder"
    chunk = np.random.default_rng(1).standard_normal(800).astype(np.float32)
    assert_share(got_emb(chunk, 16000), want_emb(chunk, 16000), JAX_SHARE)

    light = load_preset("light")          # use_wav2vec off: the directory is not read
    light.audio.wav2vec2_checkpoint = wav2vec2_dir
    light.audio.event_checkpoint = light.audio.asr_checkpoint = None
    assert isinstance(build_audio_stack(light.audio, device="cpu")[1], HashAudioEmbedder)
