"""gvl_tpu_torch's promptable segmenter and concept tracker against
gvl_tpu's, on the CPU.

Tolerances: token ids, resized masks, tracked entities (ids, labels,
states, histories) and boxes exactly equal; the position-grid resize
within 1e-6 (f32, at most 16 taps a sample); the tiny model's f32 outputs
within 1e-5 (no reduction longer than 1024) and the trained model's
within 1e-4, each per unit of the tensor's largest magnitude where that
exceeds 1 (mask logits reach 25-60: f32 dot products of that size round
at a few 1e-6, and a 1e-5 absolute bound would hold them to one ulp).  Masks cut at the threshold
are equal cell for cell except where JAX's logit lies within 1e-4 of it;
the test counts those cells.
"""

import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models import sam as jsam
from gvl_tpu.perception import segmenter as jseg
from gvl_tpu.runtime.native import resize_mask as native_resize_mask
from gvl_tpu.training.segmenter_train import CONCEPTS, make_scene
from gvl_tpu_torch.models import sam as tsam
from gvl_tpu_torch.models.convert import sam_params_from_jax
from gvl_tpu_torch.nn.layers import load_module
from gvl_tpu_torch.perception import segmenter as tseg
from gvl_tpu_torch.runtime.resize import resize_mask

REPO = Path(__file__).resolve().parents[1]
SAM_CKPT = REPO / "outputs" / "sam_params.npz"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side in one thread: thread pools shared with the suite's
    other workers slow small ops down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_model(cfg, variables):
    with torch.device("meta"):
        model = tsam.PromptableSegmenter(cfg)
    return load_module(model, sam_params_from_jax(jax.tree.map(np.asarray, variables), cfg),
                       "cpu")


@pytest.fixture(scope="module")
def trained():
    variables = jsam.load_segmenter_npz(SAM_CKPT)
    return variables, _port_model(tsam.SamConfig(), variables)


def _clip(n=6, seed=0, height=320, width=568):
    """Synthetic gameplay: a trained-distribution scene drifting right by
    3 px a frame, on a 320 x 568 canvas."""
    rng = np.random.default_rng(seed)
    scene = make_scene(rng, height, max_draw=2)[0]
    canvas = np.concatenate([scene, make_scene(rng, height)[0]], axis=1)[:, :width]
    return [np.ascontiguousarray(np.roll(canvas, 3 * i, axis=1)) for i in range(n)]


def test_hash_tokenize_equal():
    for text in ["player", "enemy boss", "", "a b c d e f g h i j k l m n o p q r", "ÜBER item"]:
        for vocab in (4096, 97):
            np.testing.assert_array_equal(tsam.hash_tokenize(text, vocab),
                                          jsam.hash_tokenize(text, vocab))


@pytest.mark.parametrize("out", [(12, 12), (20, 20), (7, 9), (33, 16), (16, 5)])
def test_position_grid_resize_matches_jax_image_resize(out):
    grid = np.random.default_rng(0).normal(size=(16, 16, 24)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(grid), (*out, 24), "bilinear")
    got = tsam.resize_bilinear(torch.from_numpy(grid), *out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def _close(got, want, atol):
    """Within ``atol`` per unit of want's largest magnitude (at least 1)."""
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol * max(float(np.abs(want).max()), 1.0),
                               rtol=0)


@pytest.fixture(scope="module")
def tiny():
    cfg = jsam.SamConfig.tiny()
    model = jsam.PromptableSegmenter(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                    jnp.zeros((1, 16), jnp.int32))
    return jax.jit(model.apply), variables, _port_model(tsam.SamConfig.tiny(), variables)


@pytest.mark.parametrize("size", [64, 48, 80])
def test_tiny_model_matches_jax(tiny, size):
    apply, variables, port = tiny
    rng = np.random.default_rng(size)
    pixels = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    tokens = np.stack([jsam.hash_tokenize(c, 4096) for c in ("player", "enemy", "x")])
    want = apply(variables, jnp.asarray(pixels), jnp.asarray(tokens))
    with torch.no_grad():
        got = port(torch.from_numpy(pixels), torch.from_numpy(tokens))
    for key in ("mask_logits", "scores"):
        _close(got[key].numpy(), want[key], 1e-5)


@pytest.mark.parametrize("size", [192, 320])
def test_trained_image_encoder_off_size_matches_jax(trained, size):
    variables, port = trained
    pixels = np.random.default_rng(size).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jsam.PromptableSegmenter(jsam.SamConfig()).apply(
        v, x, method=jsam.PromptableSegmenter.encode_image))(variables, jnp.asarray(pixels))
    with torch.no_grad():
        got = port.image_encoder(torch.from_numpy(pixels))
    _close(got.numpy(), want, 1e-4)


def test_trained_masks_scores_match_jax(trained):
    variables, port = trained
    frames = _clip(4)
    size = 256
    from gvl_tpu_torch.runtime.resize import resize_image

    px = np.stack([resize_image(f, size, size) for f in frames]).astype(np.float32) / 255.0
    tokens = np.stack([jsam.hash_tokenize(c, 4096) for c in CONCEPTS])
    want = jax.jit(jsam.PromptableSegmenter(jsam.SamConfig()).apply)(
        variables, jnp.asarray(px), jnp.asarray(tokens))
    with torch.no_grad():
        got = port(torch.from_numpy(px), torch.from_numpy(tokens))
    want_logits = np.asarray(want["mask_logits"])
    _close(got["mask_logits"].numpy(), want_logits, 1e-4)
    _close(got["scores"].numpy(), want["scores"], 1e-4)
    near = np.abs(want_logits) <= 1e-4
    differ = (got["mask_logits"].numpy() > 0) != (want_logits > 0)
    assert not (differ & ~near).any()
    print(f"mask cells within 1e-4 of the threshold: {int(near.sum())} of {near.size}")
    assert (np.asarray(want["scores"]) > 0.3).any()     # the clip has detections


def _entities(segmenter):
    out = []
    for e in segmenter.get_all_entities():
        out.append((e.entity_id, e.concept_label, e.first_seen_frame, e.last_seen_frame,
                    e.state.value, [(f, s.value) for f, s in e.state_history],
                    {f: (m.bbox.to_xyxy(), m.area_pixels, round(m.confidence, 4))
                     for f, m in e.frame_masks.items()}))
    return out


def test_trained_tracking_equal_to_jax(trained):
    frames = _clip(6, seed=3)
    want_seg = jseg.create_sam_segmenter(checkpoint=str(SAM_CKPT))
    got_seg = tseg.create_sam_segmenter(checkpoint=str(SAM_CKPT), device="cpu")
    indices = list(range(len(frames)))
    want = want_seg.segment_batch(frames, indices, list(CONCEPTS))
    got = got_seg.segment_batch(frames, indices, list(CONCEPTS))
    assert [[e.entity_id for e in f] for f in got] == [[e.entity_id for e in f] for f in want]
    assert _entities(got_seg) == _entities(want_seg)
    assert got_seg.get_statistics() == want_seg.get_statistics()
    assert any(want)
    for ew, eg in zip(want_seg.get_all_entities(), got_seg.get_all_entities()):
        for f, m in ew.frame_masks.items():
            np.testing.assert_array_equal(eg.frame_masks[f].mask, m.mask)


@pytest.mark.parametrize("shape,out", [((64, 64), (320, 568)), ((17, 33), (5, 70)),
                                       ((64, 64), (64, 64)), ((3, 2), (1000, 7))])
def test_resize_mask_byte_equal_to_native(shape, out):
    mask = np.random.default_rng(sum(out)).random(shape) > 0.5
    got, want = resize_mask(mask, *out), native_resize_mask(mask, *out)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


def test_fake_segmenter_lifecycle_equal_to_jax():
    """The fake backend's boxes drift, then vanish for 45 frames: ACTIVE,
    OCCLUDED, LOST and TERMINATED all occur, in the same frames."""
    concepts = ["player", "boss monster"]
    frame = np.zeros((240, 320, 3), np.uint8)
    want_seg = jseg.SAMConceptSegmenter()
    got_seg = tseg.SAMConceptSegmenter()
    for idx in list(range(8)) + list(range(53, 58)):
        want_seg.segment_with_prompts(frame, idx, concepts)
        got_seg.segment_with_prompts(frame, idx, concepts)
    for idx in range(8, 53):        # nothing detected: age the entities out
        want_seg.ingest_raw([[[], []]], [idx], concepts)
        got_seg.ingest_raw([[[], []]], [idx], concepts)
    assert _entities(got_seg) == _entities(want_seg)
    states = {s for e in got_seg.get_all_entities() for _, s in e.state_history}
    assert states == set(tseg.EntityState)


def test_mask_iou_and_from_logits_equal():
    rng = np.random.default_rng(0)
    a, b = rng.random((2, 30, 40)) > 0.6
    assert tseg.mask_iou(a, b) == jseg.mask_iou(a, b)
    logits = rng.normal(size=(30, 40)).astype(np.float32)
    got, want = tseg.SegmentationMask.from_logits(logits), jseg.SegmentationMask.from_logits(logits)
    assert (got.bbox.to_xyxy(), got.area_pixels, got.confidence) == \
        (want.bbox.to_xyxy(), want.area_pixels, want.confidence)


def test_wrong_geometry_checkpoint_falls_back_to_random_weights_as_jax(caplog, monkeypatch):
    """ROADMAP C7: a checkpoint of another geometry (here the 256 px
    segmenter asked for at 192 px: its position grid has 256 rows, the
    model 144) is not an error in either package: a warning, then random
    weights (the JAX backend is stubbed to record what it is given: its
    random init takes 15 s on a CPU host)."""
    given = {}
    monkeypatch.setattr(jseg, "JaxSegmenterBackend",
                        lambda config, variables=None, mesh=None: given.update(v=variables))
    config = jseg.SAMConfig(image_size=192)
    with caplog.at_level(logging.WARNING):
        jseg.create_sam_segmenter(config, checkpoint=str(SAM_CKPT))
        got = tseg.create_sam_segmenter(tseg.SAMConfig(image_size=192),
                                        checkpoint=str(SAM_CKPT), device="cpu")
    unusable = [r for r in caplog.records if "unusable" in r.getMessage()]
    assert [r.name for r in unusable] == ["gvl_tpu.perception.segmenter",
                                          "gvl_tpu_torch.perception.segmenter"]
    assert given == {"v": None}
    ckpt_queries = jsam.load_segmenter_npz(SAM_CKPT)["params"]["decoder"]["queries"]
    assert not np.allclose(got.backend.model.decoder.queries.detach().numpy(), ckpt_queries)
    assert got.backend.model.image_encoder.pos.shape == (144, 384)
