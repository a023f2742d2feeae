"""gvl_tpu_torch's trained mini-SigLIP against gvl_tpu's, on the CPU, on the
trained weights of ``outputs/minisiglip``.

- the byte tokenizer's ids must be equal;
- unit image and text embeddings within 1e-4 of JAX's, with the pixels
  rounded to bf16 and the towers in f32 (what Flax computes with f32
  parameters);
- ``SigLIPSemanticEncoder.from_trained_checkpoint`` (``encode_image``,
  ``encode_masked_regions``) within 1e-4;
- the zero-shot frame labeler's labels on seeded gameplay frames equal to
  JAX's, confidences within 1e-4 (a label within 1e-3 of the score
  threshold would be named and excused; none is on these frames);
- the zero-shot crop evaluation, the labeler's silent no-op without a
  checkpoint, and the encoder ladder.
"""

import numpy as np
import pytest
import torch

from gvl_tpu.config import load_preset as jax_preset
from gvl_tpu.fusion import TimelineIndexer as JaxTimeline
from gvl_tpu.perception import batch as jbatch
from gvl_tpu.perception import frame_labeler as jfl
from gvl_tpu.perception import semantic as jsem
from gvl_tpu.training import siglip_train as jst
from gvl_tpu_torch.config import load_preset as port_preset
from gvl_tpu_torch.fusion import TimelineIndexer
from gvl_tpu_torch.perception import batch as tbatch
from gvl_tpu_torch.perception import frame_labeler as tfl
from gvl_tpu_torch.perception import semantic as tsem
from gvl_tpu_torch.perception.encoders import gameplay_frames
from gvl_tpu_torch.training import siglip_train as tst

CKPT = "outputs/minisiglip"
EMB_TOL = 1e-4        # unit embeddings, f32 sums in another order
THRESHOLD_MARGIN = 1e-3


@pytest.fixture(scope="module")
def models():
    jm, jv, vc, tc = jst.load_minisiglip(CKPT)
    tm, tvc, ttc = tst.load_minisiglip(CKPT, device="cpu")
    assert (tvc.hidden_size, tvc.num_layers, tvc.num_heads, tvc.image_size) == (384, 6, 6, 128)
    return jm, jv, vc, tc, tm


def test_byte_tokenize_ids_equal():
    texts = ["player", "a red enemy", "UI Element", "", "é monstre", "x" * 40,
             *jst.CAPTIONS["boss"], *jst.UNSEEN_PROMPTS.values()]
    for mp in (32, 16):
        np.testing.assert_array_equal(tst.byte_tokenize(texts, mp), jst.byte_tokenize(texts, mp))
    assert tst.CAPTIONS == jst.CAPTIONS and tst.CLASSES == jst.CLASSES
    assert tst.UNSEEN_PROMPTS == jst.UNSEEN_PROMPTS
    assert tuple(tst.ENTITY_CLASSES) == tuple(jst.ENTITY_CLASSES)


def test_image_and_text_embeddings_match_jax(models):
    import jax.numpy as jnp

    jm, jv, _, tc, tm = models
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (4, 128, 128, 3)).astype(np.uint8)
    x = (px.astype(np.float32) / 255.0 - 0.5) / 0.5
    want = np.asarray(jm.apply(jv, jnp.asarray(x).astype(jnp.bfloat16),
                               method=jst.MiniSigLIP.encode_image))
    assert want.dtype == np.float32     # Flax promotes bf16 pixels to the f32 weights
    with torch.inference_mode():
        got = tm.encode_image(torch.from_numpy(x).to(torch.bfloat16)).numpy()
    np.testing.assert_allclose(got, want, atol=EMB_TOL, rtol=0)
    ids = jst.byte_tokenize(list(jst.CAPTIONS["enemy"]) + ["the protagonist"], tc.max_position)
    want = np.asarray(jm.apply(jv, jnp.asarray(ids), method=jst.MiniSigLIP.encode_text))
    with torch.inference_mode():
        got = tm.encode_text(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=EMB_TOL, rtol=0)
    assert float(tm.logit_scale.detach()) == float(jv["params"]["logit_scale"])


def _frame_and_masks(seed, n=5):
    rng = np.random.default_rng(seed)
    frame = gameplay_frames(1, seed=seed)[0]
    masks = []
    for i in range(n):
        m = np.zeros(frame.shape[:2], bool)
        y, x = rng.integers(0, 250), rng.integers(0, 500)
        m[y:y + rng.integers(8, 60), x:x + rng.integers(8, 60)] = True
        masks.append((f"e{i}", m))
    return frame, masks


def test_from_trained_checkpoint_encodes_as_jax():
    jenc = jsem.SigLIPSemanticEncoder.from_trained_checkpoint(CKPT)
    tenc = tsem.SigLIPSemanticEncoder.from_trained_checkpoint(CKPT, device="cpu")
    assert (tenc.config.pool_strategy, tenc.config.embedding_dim,
            tenc.config.region_resolution) == ("cls", 384, 128)
    frame, masks = _frame_and_masks(3)
    np.testing.assert_allclose(tenc.encode_image(frame), jenc.encode_image(frame),
                               atol=EMB_TOL, rtol=0)
    got = tenc.encode_masked_regions(frame, masks)
    want = jenc.encode_masked_regions(frame, masks)
    assert [(e.entity_id, e.original_bbox) for e in got] == \
        [(e.entity_id, e.original_bbox) for e in want]
    np.testing.assert_allclose(np.stack([e.embedding for e in got]),
                               np.stack([e.embedding for e in want]), atol=EMB_TOL, rtol=0)


def test_frame_labeler_labels_equal_jax():
    frames = gameplay_frames(8, seed=5)
    jl = jfl.MiniSigLIPFrameLabeler(CKPT)
    tl = tfl.MiniSigLIPFrameLabeler(CKPT, device="cpu")
    assert tl.classes == jl.classes
    np.testing.assert_allclose(tl._text_emb.numpy(), np.asarray(jl._text_emb), atol=EMB_TOL)
    assert tl._proposals(np.stack(frames)) == jl._proposals(np.stack(frames))
    want, got = jl.label_frames(frames), tl.label_frames(frames)
    assert sum(map(len, want)) > 0      # these frames label something
    _, scores = tl._scores(frames)
    near = np.abs(scores - tl.score_threshold) < THRESHOLD_MARGIN
    assert not near.any(), f"scores within {THRESHOLD_MARGIN} of the threshold: {scores[near]}"
    assert [[c for c, _ in f] for f in got] == [[c for c, _ in f] for f in want]
    np.testing.assert_allclose([s for f in got for _, s in f], [s for f in want for _, s in f],
                               atol=EMB_TOL, rtol=0)


def test_emit_zero_shot_labels_as_jax_and_silent_without_a_checkpoint(tmp_path):
    from gvl_tpu_torch.perception.encoders import gameplay_frames as frames_of

    frames = [(float(i), f) for i, f in enumerate(frames_of(6, seed=7))]
    jcfg, tcfg = jax_preset("light"), port_preset("light")
    jt, tt = JaxTimeline(), TimelineIndexer()
    n_j = jfl.emit_zero_shot_labels(frames, jcfg, jt)
    n_t = tfl.emit_zero_shot_labels(frames, tcfg, tt, device="cpu")
    assert n_t == n_j > 0
    assert [(e.timestamp, e.description, e.entity_id) for e in tt.events] == \
        [(e.timestamp, e.description, e.entity_id) for e in jt.events]
    # no mini-SigLIP checkpoint resolves: both emit nothing, without a word
    for cfg in (jcfg, tcfg):
        cfg.perception.siglip_checkpoint = str(tmp_path / "absent")
    assert jfl.emit_zero_shot_labels(frames, jcfg, JaxTimeline()) == 0
    assert tfl.emit_zero_shot_labels(frames, tcfg, TimelineIndexer(), device="cpu") == 0


def test_evaluate_minisiglip_as_jax(models):
    _, jv, vc, tc, tm = models
    want = jst.evaluate_minisiglip(jv, vc, tc, n_crops=24, seed=7)
    got = tst.evaluate_minisiglip(tm, n_crops=24, seed=7)
    assert {k: got[k] for k in ("zero_shot_acc", "entity_acc", "negative_acc", "n")} == \
        {k: want[k] for k in ("zero_shot_acc", "entity_acc", "negative_acc", "n")}
    assert abs(got["margin"] - want["margin"]) < EMB_TOL


def test_siglip_encoder_ladder_as_jax(tmp_path):
    jcfg, tcfg = jax_preset("light"), port_preset("light")
    assert type(tbatch.build_siglip_encoder(tcfg, device="cpu").backend).__name__ == \
        "TorchSigLIPBackend" and type(jbatch.build_siglip_encoder(jcfg).backend).__name__ == \
        "JaxSigLIPBackend"
    for cfg in (jcfg, tcfg):
        cfg.perception.siglip_checkpoint = None
    assert type(tbatch.build_siglip_encoder(tcfg, device="cpu").backend).__name__ == \
        type(jbatch.build_siglip_encoder(jcfg).backend).__name__ == "DeterministicFakeBackend"
    hf = tmp_path / "hf_siglip"
    hf.mkdir()
    tcfg.perception.siglip_checkpoint = str(hf)
    with pytest.raises(NotImplementedError, match="A10"):
        tbatch.build_siglip_encoder(tcfg, device="cpu")
