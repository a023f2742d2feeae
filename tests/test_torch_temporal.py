"""gvl_tpu_torch's temporal stack against gvl_tpu's, on the CPU.

- VideoMAE at a tiny configuration (the Flax initialisation, converted) and
  the trained clip classifier of ``outputs/videomae``: clip embeddings and
  softmax probabilities within 1e-4, ``classify_clips``' winners and
  ``extract_clip_embeddings``' TEMPORAL events equal, the evaluation's
  counts equal;
- the hash fakes (``HashFrameEncoder``, ``HashClipEncoder``) byte-equal;
- HiCo's ``segment_and_compress`` on the trained ``outputs/hico_params.npz``
  at the FRAME level (bytes) and the CLIP level (within 1e-4; B1 at 8
  heads of 176); the VIDEO level fails on that file in both;
- ROADMAP C8, the random-init fallback of a missing or mis-shaped HiCo
  checkpoint, kept as in JAX: the same shapes and a warning, and bits that
  differ (the two packages' random draws are their own);
- ``TemporalContextManager``'s rendering byte-equal;
- the clip-encoder ladder (trained, hash fake, HF rung raising A10).
"""

import logging

import numpy as np
import pytest
import torch

from gvl_tpu.config import load_preset as jax_preset
from gvl_tpu.fusion import TimelineIndexer as JaxTimeline
from gvl_tpu.models import videomae as jvm
from gvl_tpu.temporal import clip_encoder as jce
from gvl_tpu.temporal import context_manager as jcm
from gvl_tpu.temporal import hico as jhico
from gvl_tpu.training import videomae_train as jvt
from gvl_tpu_torch.config import load_preset as port_preset
from gvl_tpu_torch.fusion import TimelineIndexer
from gvl_tpu_torch.models import videomae as tvm
from gvl_tpu_torch.models.convert import videomae_params_from_jax
from gvl_tpu_torch.nn.layers import load_module
from gvl_tpu_torch.temporal import clip_encoder as tce
from gvl_tpu_torch.temporal import context_manager as tcm
from gvl_tpu_torch.temporal import hico as thico
from gvl_tpu_torch.training import videomae_train as tvt

VMAE = "outputs/videomae"
TOL = 1e-4      # f32 activations and probabilities, sums in another order


def _events(timeline):
    return [(e.timestamp, e.modality.value, e.description, e.priority.value, e.duration,
             e.entity_id) for e in timeline.events]


def test_tiny_videomae_matches_jax():
    import jax
    import jax.numpy as jnp

    cfg = jvm.VideoMAEConfig.tiny()
    video = np.random.default_rng(0).standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    model = jvm.VideoMAEEncoder(cfg)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(video))
    want = model.apply(variables, jnp.asarray(video))
    tcfg = tvm.VideoMAEConfig.tiny()
    with torch.device("meta"):
        port = tvm.VideoMAEEncoder(tcfg)
    port = load_module(port, videomae_params_from_jax(
        jax.tree.map(np.asarray, variables), tcfg), "cpu")
    with torch.inference_mode():
        got = port(torch.from_numpy(video))
    for key in ("last_hidden_state", "clip_embedding"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=TOL, rtol=0)
    np.testing.assert_array_equal(tvm.sinusoid_table(9, 32), jvm.sinusoid_table(9, 32))


@pytest.fixture(scope="module")
def clip_encoders():
    return jvt.TrainedClipEncoder.from_dir(VMAE), tvt.TrainedClipEncoder.from_dir(VMAE,
                                                                                device="cpu")


def _clips(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        clip, _ = tvt.make_clip(rng, 112, 16, ("base", "aug", "holdout")[i % 3])
        out.append(clip)
    return out


def test_make_clip_is_byte_identical():
    for style in ("base", "aug", "holdout"):
        got = tvt.make_clip(np.random.default_rng(3), 112, 16, style)
        want = jvt.make_clip(np.random.default_rng(3), 112, 16, style)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_trained_clip_encoder_matches_jax(clip_encoders):
    je, te = clip_encoders
    assert (te.config.hidden_size, te.config.num_layers, te.config.num_heads) == (256, 6, 4)
    clips = _clips(4, seed=11)
    np.testing.assert_allclose(te.encode_clips(clips), je.encode_clips(clips), atol=TOL,
                               rtol=0)
    want, got = je.classify_clips(clips), te.classify_clips(clips)
    for g, w in zip(got, want):
        for key in ("direction", "kind", "event"):
            assert g[key][0] == w[key][0]
            assert abs(g[key][1] - w[key][1]) < TOL


def test_extract_clip_embeddings_events_match_jax(clip_encoders):
    je, te = clip_encoders
    frames = [(0.5 * i, f) for i, f in enumerate(np.concatenate(_clips(2, seed=12)))]
    jt, tt = JaxTimeline(), TimelineIndexer()
    want = jce.extract_clip_embeddings(frames, je, timeline=jt)
    got = tce.extract_clip_embeddings(frames, te, timeline=tt)
    assert [t for t, _ in got] == [t for t, _ in want] == [0.0, 4.0, 8.0]
    np.testing.assert_allclose(np.stack([e for _, e in got]), np.stack([e for _, e in want]),
                               atol=TOL, rtol=0)
    assert _events(tt) and _events(tt) == _events(jt)
    np.testing.assert_allclose([e.confidence for e in tt.events],
                               [e.confidence for e in jt.events], atol=TOL, rtol=0)


def test_evaluate_clip_encoder_counts_match_jax(clip_encoders):
    je, te = clip_encoders
    _, params = jvt.load_clip_encoder(VMAE)
    for shuffle in (False, True):
        want = jvt.evaluate_clip_encoder(params, je.config, n_clips=16, seed=5,
                                         shuffle_frames=shuffle)
        got = tvt.evaluate_clip_encoder(te.model, n_clips=16, seed=5, shuffle_frames=shuffle)
        assert got == want


def test_hash_encoders_are_byte_identical():
    frames = np.random.default_rng(2).integers(0, 256, (5, 24, 32, 3), dtype=np.uint8)
    np.testing.assert_array_equal(thico.HashFrameEncoder(64)(frames),
                                  jhico.HashFrameEncoder(64)(frames))
    clips = [frames, frames[:3]]
    np.testing.assert_array_equal(tce.HashClipEncoder(48).encode_clips(clips),
                                  jce.HashClipEncoder(48).encode_clips(clips))


def test_hico_on_the_trained_checkpoint_matches_jax():
    frames = np.random.default_rng(4).integers(0, 256, (26, 24, 32, 3), dtype=np.uint8)
    jm = jhico.TemporalCompressionModule()
    tm = thico.TemporalCompressionModule(device="cpu")
    assert sorted(n for n, _ in tm.compressor.named_children()) == ["frame_to_clip"]
    for level in (jhico.CompressionLevel.FRAME, jhico.CompressionLevel.CLIP):
        want = jm.segment_and_compress(frames, fps=2.0, target_level=level)
        got = tm.segment_and_compress(frames, fps=2.0,
                                      target_level=thico.CompressionLevel(level.value))
        assert [(t.start_time, t.end_time, t.source_frame_count, t.compression_level.value)
                for t in got] == [(t.start_time, t.end_time, t.source_frame_count,
                                   t.compression_level.value) for t in want]
        got_e, want_e = np.stack([t.embedding for t in got]), np.stack([t.embedding for t in want])
        if level is jhico.CompressionLevel.FRAME:
            np.testing.assert_array_equal(got_e, want_e)
        else:
            assert len(got) == 4      # 4 clips: the power-of-two bucket holds them exactly
            np.testing.assert_allclose(got_e, want_e, atol=TOL, rtol=0)
    assert [t.end_time for t in tm.get_rolling_context(13.0)] == \
        [t.end_time for t in jm.get_rolling_context(13.0)]
    # the trained file holds no clip_to_video pool: the VIDEO level fails in both
    with pytest.raises(Exception):
        jm.segment_and_compress(frames, fps=2.0, target_level=jhico.CompressionLevel.VIDEO)
    with pytest.raises(KeyError, match="clip_to_video"):
        tm.segment_and_compress(frames, fps=2.0, target_level=thico.CompressionLevel.VIDEO)


def test_c8_hico_random_init_fallback_as_jax(tmp_path, caplog):
    """ROADMAP C8: without a usable checkpoint both packages compress with
    a random initialisation: a missing file silently, a mis-shaped one with
    a warning.  The shapes agree; the bits cannot (Flax's PRNGKey(0) draw
    against the port's torch.Generator), which is the divergence named."""
    frames = np.random.default_rng(6).integers(0, 256, (20, 16, 16, 3), dtype=np.uint8)
    jm = jhico.TemporalCompressionModule(checkpoint=str(tmp_path / "absent.npz"))
    tm = thico.TemporalCompressionModule(checkpoint=str(tmp_path / "absent.npz"), device="cpu")
    want = jm.segment_and_compress(frames, fps=2.0)
    got = tm.segment_and_compress(frames, fps=2.0)
    assert len(got) == len(want) and got[0].embedding.shape == want[0].embedding.shape
    assert not np.allclose(got[0].embedding, want[0].embedding, atol=1e-2)
    assert sorted(n for n, _ in tm.compressor.named_children()) == ["clip_to_video",
                                                                     "frame_to_clip"]
    small = thico.HiCoConfig(max_positions=512)
    with caplog.at_level(logging.WARNING):
        thico.TemporalCompressionModule(small, device="cpu")
        jhico.TemporalCompressionModule(jhico.HiCoConfig(max_positions=512))
    assert sum("random init" in r.getMessage() for r in caplog.records) == 2


def test_context_manager_renders_byte_equal():
    jctx, tctx = jcm.TemporalContextManager(), tcm.TemporalContextManager()
    rng = np.random.default_rng(8)
    for i in range(140):
        text = f"event {i}: " + "x" * int(rng.integers(5, 90))
        for ctx in (jctx, tctx):
            ctx.add_observation(2.5 * i, 2.5 * i + 2.0, text)
    for budget in (300, 1500, 4000):
        assert tctx.get_context_for_llm(budget) == jctx.get_context_for_llm(budget)
    assert tctx.get_statistics() == jctx.get_statistics()
    assert [e.render() for e in tctx.get_entries(tcm.ContextLevel.SCENE)] == \
        [e.render() for e in jctx.get_entries(jcm.ContextLevel.SCENE)]


def test_clip_encoder_ladder(tmp_path):
    jcfg, tcfg = jax_preset("light"), port_preset("light")
    assert (type(tce.build_clip_encoder(tcfg, device="cpu")).__name__,
            type(jce.build_clip_encoder(jcfg)).__name__) == ("TrainedClipEncoder",) * 2
    for cfg in (jcfg, tcfg):
        cfg.perception.videomae_checkpoint = str(tmp_path / "absent")
    assert type(tce.build_clip_encoder(tcfg, device="cpu")).__name__ == \
        type(jce.build_clip_encoder(jcfg)).__name__ == "HashClipEncoder"
    hf = tmp_path / "hf_videomae"
    hf.mkdir()
    tcfg.perception.videomae_checkpoint = str(hf)
    with pytest.raises(NotImplementedError, match="A10"):
        tce.build_clip_encoder(tcfg, device="cpu")
