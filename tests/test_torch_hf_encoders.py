"""The HF converters of Whisper, VideoMAE and SigLIP in gvl_tpu_torch against
gvl_tpu's and ``transformers``, and the HF rungs of the perception ladders.

Tiny random ``transformers`` models (the geometries of
``tests/test_encoders.py``, ``test_encoder_ladder.py`` and
``test_open_vocab.py``) go through JAX's ``convert_hf_*`` and the port's.
Port against JAX: f32, within 1e-5 of the largest magnitude; port against
``transformers``: within 1e-4.  Then each rung resolves a directory saved
with ``save_pretrained`` (tokenizers built offline) in both packages and
gives JAX's transcripts, clip vectors, embeddings and detections: the HF
Whisper rung of ``build_audio_stack``, the VideoMAE rung of
``build_clip_encoder``, the SigLIP rung of ``build_siglip_encoder`` (its
bf16 backend and its fused W8A8 tower) and the SAM + SigLIP composite of
``build_segmenter``.  The MiniLM and wav2vec2 rungs are in
``tests/test_torch_minilm.py`` and ``test_torch_wav2vec2.py``.
"""

import os

os.environ.setdefault("USE_TF", "0")
os.environ["HF_HUB_OFFLINE"] = "1"
os.environ["TRANSFORMERS_OFFLINE"] = "1"

import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gvl_tpu.config import load_preset as jax_preset  # noqa: E402
from gvl_tpu.models import siglip as jsig  # noqa: E402
from gvl_tpu.models import videomae as jvm  # noqa: E402
from gvl_tpu.models import whisper as jw  # noqa: E402
from gvl_tpu_torch.config import load_preset as port_preset  # noqa: E402
from gvl_tpu_torch.models import siglip as tsig  # noqa: E402
from gvl_tpu_torch.models import videomae as tvm  # noqa: E402
from gvl_tpu_torch.models import whisper as tw  # noqa: E402

JAX_SHARE = 1e-5
HF_SHARE = 1e-4
WORDS = "the boss enemy player item a sprite of health bar door chest".split()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def share(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def cosines(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


# --------------------------------------------------------------------------
# converters
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_whisper():
    from transformers import WhisperConfig, WhisperModel

    torch.manual_seed(0)
    return WhisperModel(WhisperConfig(
        d_model=32, encoder_layers=1, decoder_layers=1, encoder_attention_heads=2,
        decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=16,
        max_source_positions=100, max_target_positions=60, vocab_size=51000)).eval()


def test_whisper_converter_matches_jax_and_hf(hf_whisper):
    sd = hf_whisper.state_dict()
    cfg = tw.WhisperConfig.tiny_random()
    hf_cfg = tw.hf_whisper_config(hf_whisper.config)
    assert (hf_cfg.d_model, hf_cfg.num_heads, hf_cfg.ffn_dim, hf_cfg.num_mel_bins,
            hf_cfg.max_target_positions) == (32, 2, 64, 16, 60)
    model = tw.load_whisper(cfg, tw.convert_hf_whisper(sd, cfg), device="cpu")
    jvars = {"params": jw.convert_hf_whisper(sd, jw.WhisperConfig.tiny_random())}
    jmodel = jw.WhisperModel(jw.WhisperConfig.tiny_random())
    mel = np.random.RandomState(0).randn(1, 200, 16).astype(np.float32)
    tokens = np.array([[50258, 11, 22, 33]], np.int64)
    with torch.no_grad():
        got = model(torch.from_numpy(mel), torch.from_numpy(tokens)).numpy()
        ref = hf_whisper(input_features=torch.from_numpy(mel.transpose(0, 2, 1)),
                         decoder_input_ids=torch.from_numpy(tokens)).last_hidden_state
        ref = (ref @ hf_whisper.decoder.embed_tokens.weight.T).numpy()
    want = np.asarray(jax.jit(jmodel.apply)(jvars, jnp.asarray(mel), jnp.asarray(tokens)))
    assert share(got, want) <= JAX_SHARE
    assert share(got, ref) <= HF_SHARE
    prompt = np.array([[50258, 11]], np.int64)
    got_tokens = tw.greedy_decode_cached(model, torch.from_numpy(mel), torch.from_numpy(prompt),
                                         max_new_tokens=12)
    want_tokens = jw.greedy_decode_cached(jmodel, jvars, jnp.asarray(mel), jnp.asarray(prompt),
                                          max_new_tokens=12)
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))


def hf_videomae():
    from transformers import VideoMAEConfig, VideoMAEModel

    torch.manual_seed(0)
    return VideoMAEModel(VideoMAEConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2,
        image_size=32, patch_size=16, num_frames=4, tubelet_size=2)).eval()


def test_videomae_converter_matches_jax_and_hf():
    hf = hf_videomae()
    sd = hf.state_dict()
    cfg = tvm.hf_videomae_config(hf.config)
    assert cfg == tvm.VideoMAEConfig.tiny()
    model = tvm.load_videomae(cfg, tvm.convert_hf_videomae(sd, cfg), device="cpu")
    jvars = {"params": jvm.convert_hf_videomae(sd, jvm.VideoMAEConfig.tiny())}
    video = np.random.RandomState(0).randn(2, 4, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(video))
        ref = hf(pixel_values=torch.from_numpy(video.transpose(0, 1, 4, 2, 3)))
    want = jax.jit(jvm.VideoMAEEncoder(jvm.VideoMAEConfig.tiny()).apply)(
        jvars, jnp.asarray(video))
    for key in ("last_hidden_state", "clip_embedding"):
        assert share(got[key].numpy(), want[key]) <= JAX_SHARE
    assert share(got["last_hidden_state"].numpy(), ref.last_hidden_state.numpy()) <= HF_SHARE


# the fused W8A8 tower's geometry in tests/test_torch_semantic.py
VISION = dict(hidden_size=128, intermediate_size=192, num_hidden_layers=2, num_attention_heads=4,
              image_size=56, patch_size=14)
TEXT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
            vocab_size=256, max_position_embeddings=16, projection_size=128,
            hidden_act="gelu_pytorch_tanh")


@pytest.fixture(scope="module")
def hf_siglip():
    """A tiny ``SiglipModel`` (vision and text towers sharing a 128-wide
    embedding space)."""
    from transformers import SiglipConfig, SiglipModel

    torch.manual_seed(0)
    return SiglipModel(SiglipConfig(vision_config=VISION, text_config=TEXT)).eval()


def test_siglip_vision_converter_matches_jax_and_hf(hf_siglip):
    hf = hf_siglip.vision_model
    sd = {f"vision_model.{k}": v for k, v in hf.state_dict().items()}
    geometry = dict(hidden_size=128, intermediate_size=192, num_layers=2, num_heads=4,
                    patch_size=14, image_size=56)
    cfg = tsig.SigLIPVisionConfig(**geometry)
    tower = tsig.load_tower(cfg, tsig.convert_hf_siglip_vision(sd, cfg), device="cpu")
    jcfg = jsig.SigLIPVisionConfig(**geometry)
    jvars = {"params": jsig.convert_hf_siglip_vision(sd, jcfg)}
    pixels = np.random.RandomState(0).randn(2, 56, 56, 3).astype(np.float32)
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels))
        ref = hf(pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2)))
    want = jax.jit(jsig.SigLIPVisionTower(jcfg).apply)(jvars, jnp.asarray(pixels))
    for key in ("last_hidden_state", "pooled"):
        assert share(got[key].numpy(), want[key]) <= JAX_SHARE
    assert share(got["last_hidden_state"].numpy(), ref.last_hidden_state.numpy()) <= HF_SHARE
    assert share(got["pooled"].numpy(), ref.pooler_output.numpy()) <= HF_SHARE


def test_siglip_text_converter_matches_jax_and_hf(hf_siglip):
    hf = hf_siglip.text_model
    sd = {f"text_model.{k}": v for k, v in hf.state_dict().items()}
    cfg = tsig.SigLIPTextConfig.tiny(projection_size=128)
    tower = tsig.load_text_tower(cfg, tsig.convert_hf_siglip_text(sd, cfg), device="cpu")
    jcfg = jsig.SigLIPTextConfig.tiny(projection_size=128)
    jvars = {"params": jsig.convert_hf_siglip_text(sd, jcfg)}
    ids = np.random.RandomState(1).randint(0, 256, (3, 16))
    with torch.no_grad():
        got = tower(torch.from_numpy(ids))
        ref = hf(input_ids=torch.from_numpy(ids))
    want = jax.jit(jsig.SigLIPTextTower(jcfg).apply)(jvars, jnp.asarray(ids))
    for key in ("last_hidden_state", "pooled"):
        assert share(got[key].numpy(), want[key]) <= JAX_SHARE
    assert share(got["last_hidden_state"].numpy(), ref.last_hidden_state.numpy()) <= HF_SHARE
    assert share(got["pooled"].numpy(), ref.pooler_output.numpy()) <= HF_SHARE


# --------------------------------------------------------------------------
# rungs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    """A tiny Whisper with an offline ``WhisperTokenizer`` (letters, a space
    and the four prompt specials)."""
    from transformers import WhisperConfig, WhisperModel, WhisperTokenizer

    d = tmp_path_factory.mktemp("whisper")
    specials = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|transcribe|>",
                "<|notimestamps|>"]
    vocab = {ch: i for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz")}
    vocab["Ġ"] = len(vocab)
    for s in specials:
        vocab[s] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    tok = WhisperTokenizer(vocab_file=str(d / "vocab.json"), merges_file=str(d / "merges.txt"))
    tok.add_special_tokens({"additional_special_tokens": specials})
    tok.save_pretrained(d)
    eot = vocab["<|endoftext|>"]
    torch.manual_seed(0)
    WhisperModel(WhisperConfig(
        d_model=32, encoder_layers=1, decoder_layers=1, encoder_attention_heads=2,
        decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=80,
        max_source_positions=1500, max_target_positions=448, vocab_size=len(vocab),
        decoder_start_token_id=vocab["<|startoftranscript|>"], eos_token_id=eot,
        bos_token_id=eot, pad_token_id=eot)).save_pretrained(d)
    return str(d)


def test_whisper_rung_transcribes_as_jax(whisper_dir):
    from gvl_tpu.audio import build_audio_stack as jax_build
    from gvl_tpu_torch.audio.processor import WhisperTorchASR, build_audio_stack

    tcfg, jcfg = port_preset("light"), jax_preset("light")
    for cfg in (tcfg, jcfg):
        cfg.audio.whisper_checkpoint = whisper_dir
        cfg.audio.event_checkpoint = cfg.audio.asr_checkpoint = None
    got_proc, _ = build_audio_stack(tcfg.audio, device="cpu")
    want_proc, _ = jax_build(jcfg.audio)
    assert isinstance(got_proc.asr, WhisperTorchASR)
    assert type(want_proc.asr).__name__ == "WhisperJaxASR"
    wav = np.sin(np.linspace(0, 440 * 2 * np.pi, 16000)).astype(np.float32)
    got_tokens = got_proc.asr.decode(wav)[0].numpy()
    want_tokens = np.asarray(want_proc.asr._run(jnp.asarray(wav)))[0]
    np.testing.assert_array_equal(got_tokens, want_tokens)
    assert got_proc.asr(wav, 16000) == want_proc.asr(wav, 16000)


@pytest.fixture(scope="module")
def videomae_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("videomae")
    hf_videomae().save_pretrained(d)
    return str(d)


def test_videomae_rung_gives_jax_clip_vectors(videomae_dir):
    from gvl_tpu.temporal.clip_encoder import build_clip_encoder as jax_build
    from gvl_tpu_torch.temporal.clip_encoder import TorchVideoMAEClipEncoder, build_clip_encoder

    tcfg, jcfg = port_preset("light"), jax_preset("light")
    for cfg in (tcfg, jcfg):
        cfg.perception.videomae_checkpoint = videomae_dir
    got_enc, want_enc = build_clip_encoder(tcfg, device="cpu"), jax_build(jcfg)
    assert isinstance(got_enc, TorchVideoMAEClipEncoder)
    assert type(want_enc).__name__ == "JaxVideoMAEClipEncoder"
    rng = np.random.default_rng(0)
    clips = [rng.integers(0, 256, (n, 40, 56, 3), dtype=np.uint8) for n in (2, 4, 7)]
    got, want = got_enc.encode_clips(clips), want_enc.encode_clips(clips)
    assert got.shape == (3, 32) and got.dtype == np.float32
    assert share(got, want) <= JAX_SHARE
    assert got_enc.encode_clips([]).shape == (0, 32)


def _word_tokenizer():
    """A word-level fast tokenizer over WORDS, [PAD] 0 and [UNK] 1."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"[PAD]": 0, "[UNK]": 1, **{w: i + 2 for i, w in enumerate(WORDS)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]", unk_token="[UNK]")


@pytest.fixture(scope="module")
def siglip_dir(tmp_path_factory, hf_siglip):
    d = tmp_path_factory.mktemp("siglip")
    hf_siglip.save_pretrained(d)
    _word_tokenizer().save_pretrained(d)
    return str(d)


@pytest.mark.parametrize("fused", [False, True], ids=["bf16", "fused"])
def test_siglip_rung_embeds_as_jax(siglip_dir, fused):
    """Without ``siglip_fused`` the tower in f32 (bf16 pixels, as Flax
    promotes) gives JAX's embeddings within 1e-5; the fused W8A8 towers hold
    a pooled cosine of 0.999, as in ``tests/test_torch_semantic.py`` (they
    calibrate on other pixels: ROADMAP C4)."""
    from gvl_tpu.perception import batch as jbatch
    from gvl_tpu_torch.perception import batch as tbatch
    from gvl_tpu_torch.perception.semantic import FusedSigLIPBackend, TorchSigLIPBackend

    tcfg, jcfg = port_preset("standard"), jax_preset("standard")
    for cfg in (tcfg, jcfg):
        cfg.perception.siglip_checkpoint = siglip_dir
        cfg.perception.siglip_fused = fused
    got_enc, want_enc = tbatch.build_siglip_encoder(tcfg, device="cpu"), \
        jbatch.build_siglip_encoder(jcfg)
    assert isinstance(got_enc.backend, FusedSigLIPBackend if fused else TorchSigLIPBackend)
    assert type(want_enc.backend).__name__ == ("FusedSigLIPBackend" if fused
                                               else "JaxSigLIPBackend")
    # regions (128-pixel canvases) rather than whole frames (384): the same
    # backend at a ninth of the tokens
    rng = np.random.default_rng(1)
    frame = rng.integers(0, 256, (70, 100, 3), dtype=np.uint8)
    masks = []
    for i, (y, x, h, w) in enumerate(((5, 8, 30, 40), (30, 50, 35, 45), (0, 0, 70, 20))):
        m = np.zeros((70, 100), bool)
        m[y:y + h, x:x + w] = True
        masks.append((f"e{i}", m))
    got = np.stack([e.embedding for e in got_enc.encode_masked_regions(frame, masks)])
    want = np.stack([e.embedding for e in want_enc.encode_masked_regions(frame, masks)])
    assert got.shape == (3, 128)
    if fused:
        assert cosines(got, want).min() >= 0.999
    else:
        assert share(got, want) <= JAX_SHARE


@pytest.fixture(scope="module")
def sam_dir(tmp_path_factory):
    from transformers import SamModel

    from tests.test_torch_sam_vit import hf_sam_config

    d = tmp_path_factory.mktemp("sam")
    torch.manual_seed(0)
    SamModel(hf_sam_config(layers=2)).eval().save_pretrained(d)
    return str(d)


def _detections(results):
    return [[[(d["mask"].mask.tobytes(), tuple(vars(d["mask"].bbox).values()),
               d["mask"].area_pixels)
              for d in per_concept] for per_concept in frame] for frame in results]


def test_open_vocab_rung_detects_as_jax(sam_dir, siglip_dir):
    """``build_segmenter`` with ``sam_backend="open_vocab"`` and HF SAM and
    SigLIP directories builds the composite in both packages; with every
    proposal kept (``score_threshold`` -10), the detections (masks, boxes,
    areas) are JAX's and their scores within 1e-5."""
    from gvl_tpu.perception import batch as jbatch
    from gvl_tpu.perception.open_vocab import create_open_vocab_segmenter as jax_create
    from gvl_tpu_torch.perception import batch as tbatch
    from gvl_tpu_torch.perception.open_vocab import (
        OpenVocabSamBackend,
        create_open_vocab_segmenter,
    )

    tcfg, jcfg = port_preset("standard"), jax_preset("standard")
    for cfg in (tcfg, jcfg):
        cfg.perception.sam_backend = "open_vocab"
        cfg.perception.sam_vit_dir = sam_dir
        cfg.perception.siglip_checkpoint = siglip_dir
        cfg.perception.sam_checkpoint = None
    assert isinstance(tbatch.build_segmenter(tcfg, device="cpu").backend, OpenVocabSamBackend)
    assert type(jbatch.build_segmenter(jcfg).backend).__name__ == "OpenVocabSamBackend"

    got_seg = create_open_vocab_segmenter(sam_dir, siglip_dir, device="cpu", grid=2,
                                          score_threshold=-10.0)
    want_seg = jax_create(sam_dir, siglip_dir, grid=2, score_threshold=-10.0)
    frames = list(np.random.default_rng(2).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8))
    concepts = ["the boss", "a health bar", "door"]
    got = got_seg.backend(frames, concepts, [0, 1])
    want = want_seg.backend(frames, concepts, [0, 1])
    assert _detections(got) == _detections(want)
    assert sum(len(c) for f in got for c in f) > 0
    got_conf = [d["mask"].confidence for f in got for c in f for d in c]
    want_conf = [d["mask"].confidence for f in want for c in f for d in c]
    assert share(got_conf, want_conf) <= JAX_SHARE


# --------------------------------------------------------------------------
# HF layouts drawn without transformers (what the card converts)
# --------------------------------------------------------------------------

def _layout_case(name):
    """(HF model, the port's layout of it, the port's converter, the port's
    model) at a small config."""
    import transformers as T

    from gvl_tpu_torch.models import hf_layouts as L
    from gvl_tpu_torch.models import minilm, sam_vit, wav2vec2

    torch.manual_seed(0)
    if name == "bert":
        cfg = minilm.MiniLMConfig.tiny()
        hf = T.BertModel(T.BertConfig(vocab_size=512, hidden_size=32, num_hidden_layers=2,
                                      num_attention_heads=2, intermediate_size=64,
                                      max_position_embeddings=64), add_pooling_layer=False)
        return hf, L.bert_layout(cfg), lambda s: minilm.convert_hf_bert(s, cfg), \
            minilm.MiniLMModel(cfg)
    if name.startswith("wav2vec2"):
        stable = name.endswith("stable")
        hf = T.Wav2Vec2Model(T.Wav2Vec2Config(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
            conv_dim=(16, 16, 8), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 2),
            num_feat_extract_layers=3, conv_bias=stable, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, do_stable_layer_norm=stable,
            feat_extract_norm="layer" if stable else "group"))
        cfg = wav2vec2.hf_wav2vec2_config(hf.config)
        return hf, L.wav2vec2_layout(cfg), lambda s: wav2vec2.convert_hf_wav2vec2(s, cfg), \
            wav2vec2.Wav2Vec2Encoder(cfg)
    if name == "whisper":
        hf = T.WhisperModel(T.WhisperConfig(
            d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
            decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=16,
            max_source_positions=100, max_target_positions=60, vocab_size=51000))
        cfg = tw.hf_whisper_config(hf.config)
        return hf, L.whisper_layout(cfg), lambda s: tw.convert_hf_whisper(s, cfg), \
            tw.WhisperModel(cfg)
    if name == "videomae":
        hf = hf_videomae()
        cfg = tvm.hf_videomae_config(hf.config)
        return hf, L.videomae_layout(cfg), lambda s: tvm.convert_hf_videomae(s, cfg), \
            tvm.VideoMAEEncoder(cfg)
    if name == "siglip_vision":
        hf = T.SiglipVisionModel(T.SiglipVisionConfig(**VISION))
        cfg = tsig.SigLIPVisionConfig(hidden_size=128, intermediate_size=192, num_layers=2,
                                      num_heads=4, patch_size=14, image_size=56)
        return hf, L.siglip_vision_layout(cfg), \
            lambda s: tsig.convert_hf_siglip_vision(s, cfg), tsig.SigLIPVisionTower(cfg)
    if name == "siglip_text":
        hf = T.SiglipTextModel(T.SiglipTextConfig(**TEXT))
        cfg = tsig.SigLIPTextConfig.tiny(projection_size=128)
        return hf, L.siglip_text_layout(cfg), lambda s: tsig.convert_hf_siglip_text(s, cfg), \
            tsig.SigLIPTextTower(cfg)
    from tests.test_torch_sam_vit import hf_sam_config

    hf = T.SamModel(hf_sam_config())
    cfg = sam_vit.SamViTConfig.from_hf(hf.config)
    return hf, L.sam_layout(cfg), lambda s: sam_vit.convert_hf_sam(s, cfg), sam_vit.SamViT(cfg)


@pytest.mark.parametrize("name", ["bert", "wav2vec2_stable", "wav2vec2_group", "whisper",
                                  "videomae", "siglip_vision", "siglip_text", "sam"])
def test_hf_layouts_are_the_transformers_state_dicts(name):
    """Each layout the card draws is the ``state_dict()`` of its
    ``transformers`` model, name for name and shape for shape, and its
    seeded weights convert to the port model's state dict."""
    from gvl_tpu_torch.models.hf_layouts import random_state

    hf, layout, convert, model = _layout_case(name)
    assert {k: tuple(v.shape) for k, v in hf.state_dict().items()} == layout
    state = random_state(layout, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.isfinite(t).all() for t in state.values())
    converted = convert(state)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in converted.items()} == want
