"""gvl_tpu_torch's region semantic encoder against gvl_tpu's, on the CPU.

The host side (the port's numpy ``resize_image``, region extraction,
canvas preparation, bucket padding, the fake backend) must give the JAX
package's bytes exactly.  The fused W8A8 backend and the encoder are held
to JAX's on one small tower (hidden 128, FFN 192, 4 heads) with carried
weights and the same calibration pixels: pooled cosine >= 0.999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models.siglip import SigLIPVisionConfig as JaxConfig
from gvl_tpu.models.siglip import SigLIPVisionTower as JaxTower
from gvl_tpu.perception import semantic as jsem
from gvl_tpu.runtime.native import resize_image as native_resize
from gvl_tpu_torch.models.convert import siglip_params_from_jax
from gvl_tpu_torch.models import siglip as tsig
from gvl_tpu_torch.models.siglip import SigLIPVisionConfig, load_tower
from gvl_tpu_torch.perception import semantic as tsem
from gvl_tpu_torch.runtime.resize import resize_image

GEOMETRY = dict(hidden_size=128, intermediate_size=192, num_layers=2, num_heads=4,
                image_size=56)
NAFLEX = dict(quant_fused=True, base_resolution=56, region_resolution=28,
              embedding_dim=128, batch_size=4)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("seed", range(4))
def test_resize_image_is_byte_identical_to_native(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        sh, sw = rng.integers(1, 160, 2)
        channels = int(rng.choice([1, 3]))
        image = rng.integers(0, 256, (sh, sw, channels), dtype=np.uint8)
        dh, dw = (int(v) for v in rng.integers(1, 200, 2))
        got = resize_image(image, dh, dw)
        assert got.shape == (dh, dw, channels)
        np.testing.assert_array_equal(got, native_resize(image, dh, dw))
    gray = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    np.testing.assert_array_equal(resize_image(gray, 90, 20), native_resize(gray, 90, 20))


def test_frame_downscale_is_byte_identical_to_native():
    frame = np.random.default_rng(9).integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    np.testing.assert_array_equal(resize_image(frame, 216, 384),
                                  native_resize(frame, 216, 384))


def _frame_and_masks(seed, n=6):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    masks = []
    for i in range(n):
        mask = np.zeros((90, 120), bool)
        if i:      # the first mask is empty: a centre crop
            y, x = rng.integers(0, 60), rng.integers(0, 90)
            mask[y:y + rng.integers(3, 30), x:x + rng.integers(3, 30)] = True
        masks.append((f"e{i}", mask))
    return frame, masks


def test_region_extraction_and_canvases_match_jax():
    frame, masks = _frame_and_masks(0)
    jx = jsem.RegionExtractor(jsem.NaFlexConfig(**NAFLEX))
    tx = tsem.RegionExtractor(tsem.NaFlexConfig(**NAFLEX))
    for _, mask in masks:
        (jr, jb), (tr, tb) = jx.extract_masked_region(frame, mask), \
            tx.extract_masked_region(frame, mask)
        assert jb == tb
        np.testing.assert_array_equal(jr, tr)
        for canvas in (28, 56, 384):
            (jc, ja), (tc, ta) = jx.prepare(jr, canvas), tx.prepare(tr, canvas)
            assert ja == ta
            np.testing.assert_array_equal(jc, tc)
    jres = jsem.AspectPreservingResizer(jsem.NaFlexConfig())
    tres = tsem.AspectPreservingResizer(tsem.NaFlexConfig())
    for h, w in ((720, 1280), (1080, 1920), (500, 90), (33, 33)):
        assert jres.compute_optimal_size(h, w) == tres.compute_optimal_size(h, w)


def test_fake_backend_encoder_matches_jax():
    frame, masks = _frame_and_masks(1, n=7)
    je = jsem.SigLIPSemanticEncoder(jsem.NaFlexConfig(**NAFLEX))
    te = tsem.SigLIPSemanticEncoder(tsem.NaFlexConfig(**NAFLEX))
    for a, b in zip(je.encode_masked_regions(frame, masks),
                    te.encode_masked_regions(frame, masks)):
        assert (a.entity_id, a.original_bbox, a.aspect_ratio) == \
            (b.entity_id, b.original_bbox, b.aspect_ratio)
        np.testing.assert_array_equal(a.embedding, b.embedding)
    assert [je._bucket_pad(n) for n in range(1, 20)] == \
        [te._bucket_pad(n) for n in range(1, 20)]
    np.testing.assert_array_equal(je.encode_images_batch([frame] * 5),
                                  te.encode_images_batch([frame] * 5))


@pytest.fixture(scope="module")
def fused_pair():
    """JAX's and the port's FusedSigLIPBackend on one bf16 tower with the
    same calibration pixels."""
    jcfg = JaxConfig(**GEOMETRY)
    params = JaxTower(jcfg).init(jax.random.PRNGKey(0), jnp.ones((1, 56, 56, 3)))["params"]
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    calib = np.random.default_rng(0).normal(size=(4, 56, 56, 3)).astype(np.float32) * 0.5
    jax_backend = jsem.FusedSigLIPBackend(JaxTower(jcfg), {"params": params},
                                          calib_pixels=jnp.asarray(calib))
    state = siglip_params_from_jax(jax.tree.map(np.asarray, params), jcfg.num_layers)
    tower = load_tower(SigLIPVisionConfig(**GEOMETRY), state, "cpu")
    return jax_backend, tsem.FusedSigLIPBackend(tower, calib_pixels=calib)


def test_fused_backend_and_encoder_match_jax(fused_pair):
    jax_backend, port_backend = fused_pair
    frame, masks = _frame_and_masks(2)
    je = jsem.SigLIPSemanticEncoder(jsem.NaFlexConfig(**NAFLEX), backend=jax_backend)
    te = tsem.SigLIPSemanticEncoder(tsem.NaFlexConfig(**NAFLEX), backend=port_backend)
    want, got = je.encode_masked_regions(frame, masks), te.encode_masked_regions(frame, masks)
    assert [e.original_bbox for e in got] == [e.original_bbox for e in want]
    assert _cos(np.stack([e.embedding for e in got]),
                np.stack([e.embedding for e in want])).min() >= 0.999
    images = [np.random.default_rng(i).integers(0, 256, (70, 100, 3), dtype=np.uint8)
              for i in range(3)]
    assert _cos(te.encode_images_batch(images), je.encode_images_batch(images)).min() >= 0.999
    multi = te.encode_regions_multi([(frame, masks[:2]), (frame, []), (frame, masks[2:])])
    assert [len(m) for m in multi] == [2, 0, len(masks) - 2]


def _max_act_scales(trees):
    """One calibrated tree whose every ``act_scale`` is the largest of the
    trees' (amax / 127 is monotone, so this is the scale of the largest
    amax)."""
    def walk(nodes):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes]) for k in nodes[0]}
        return nodes[0]
    out = walk(trees)
    for i in range(len([k for k in out if k.startswith("layers_")])):
        for group, names in (("attention", ("q_proj", "k_proj", "v_proj", "o_proj")),
                             ("mlp", ("fc1", "fc2"))):
            for name in names:
                scales = [t[f"layers_{i}"][group][name]["act_scale"] for t in trees]
                out[f"layers_{i}"][group][name]["act_scale"] = jnp.max(jnp.stack(scales))
    return out


def test_encoder_list_calibration_is_jax_calibration_maxed_over_batches():
    """The encoder calibrates on a list of batches (:func:`calibration_pixels`:
    noise at the tower's size and padded region canvases).  JAX's
    ``calibrate_siglip_int8`` run on each batch, its scales maxed over the
    batches and fused by JAX, serves the same regions and frames (pooled
    cosine >= 0.999).  The list's scales are the per-batch scales' max
    exactly.  Against JAX's they are within 1e-2 relative: the dynamic
    quantize rounds every activation, and an f32 sum taken in another order
    that lands on the other side of a rounding step moves a later layer's
    amax (3.3e-3 seen on bf16 weights)."""
    from gvl_tpu.models import siglip as jsig
    from gvl_tpu.models import siglip_fused as jfused

    jcfg = JaxConfig(**GEOMETRY)
    params = JaxTower(jcfg).init(jax.random.PRNGKey(7), jnp.ones((1, 56, 56, 3)))["params"]
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    config = tsem.NaFlexConfig(**NAFLEX)
    calib = [p.numpy() for p in tsem.calibration_pixels(config, 56, "cpu")]
    assert [p.shape[1] for p in calib] == [56, 28]
    jq = jsig.quantize_siglip_int8(params)
    maxed = _max_act_scales([jsig.calibrate_siglip_int8(jcfg, jq, jnp.asarray(p))
                             for p in calib])

    state = siglip_params_from_jax(jax.tree.map(np.asarray, params), jcfg.num_layers)
    tower = load_tower(SigLIPVisionConfig(**GEOMETRY), state, "cpu")
    qstate = tsig.quantize_siglip_int8(
        {k: v.to(torch.bfloat16) for k, v in tower.state_dict().items()})
    listed = tsig.calibrate_siglip_int8(tower.config, qstate,
                                        [torch.from_numpy(p) for p in calib])
    each = [tsig.calibrate_siglip_int8(tower.config, qstate, torch.from_numpy(p))
            for p in calib]
    for i in range(jcfg.num_layers):
        for group, names in (("attention", ("q_proj", "k_proj", "v_proj", "o_proj")),
                             ("mlp", ("fc1", "fc2"))):
            for name in names:
                key = f"layers.{i}.{group}.{name}.act_scale"
                assert listed[key] == max(t[key] for t in each)
                np.testing.assert_allclose(
                    listed[key].item(),
                    float(maxed[f"layers_{i}"][group][name]["act_scale"]), rtol=1e-2)

    jax_backend = jsem.FusedSigLIPBackend(JaxTower(jcfg), {"params": params},
                                          calib_pixels=jnp.asarray(calib[0]))
    jax_backend.variables = jfused.fuse_siglip_int8(maxed, jcfg)
    port_backend = tsem.build_vision_backend(tower, config)
    je = jsem.SigLIPSemanticEncoder(jsem.NaFlexConfig(**NAFLEX), backend=jax_backend)
    te = tsem.SigLIPSemanticEncoder(config, backend=port_backend)
    frame, masks = _frame_and_masks(3)
    want, got = je.encode_masked_regions(frame, masks), te.encode_masked_regions(frame, masks)
    assert _cos(np.stack([e.embedding for e in got]),
                np.stack([e.embedding for e in want])).min() >= 0.999
    images = [np.random.default_rng(10 + i).integers(0, 256, (70, 100, 3), dtype=np.uint8)
              for i in range(3)]
    assert _cos(te.encode_images_batch(images), je.encode_images_batch(images)).min() >= 0.999


def test_companion_backend_pools_like_jax():
    """The plain tower backend (counterpart of JaxSigLIPBackend) in f32."""
    jcfg = JaxConfig(**GEOMETRY)
    params = JaxTower(jcfg).init(jax.random.PRNGKey(4), jnp.ones((1, 56, 56, 3)))["params"]
    state = siglip_params_from_jax(jax.tree.map(np.asarray, params), jcfg.num_layers)
    batch = np.random.default_rng(5).integers(0, 256, (2, 56, 56, 3), dtype=np.uint8)
    for strategy in ("mean", "max", "cls"):
        want = jsem.JaxSigLIPBackend(JaxTower(jcfg), {"params": params}, dtype="float32",
                                     pool_strategy=strategy)(batch)[1]
        got = tsem.TorchSigLIPBackend(load_tower(SigLIPVisionConfig(**GEOMETRY), state,
                                                 "cpu"),
                                      dtype="float32", pool_strategy=strategy)(batch)[1]
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_checkpoint_entry_points_name_their_roadmap_items(tmp_path):
    # the HF rung (ROADMAP A10) is ported: a directory with no checkpoint
    # fails in the loader as JAX's does (directories that load:
    # tests/test_torch_hf_encoders.py)
    with pytest.raises(OSError) as want:
        jsem.SigLIPSemanticEncoder.from_hf_checkpoint(str(tmp_path))
    with pytest.raises(OSError) as got:
        tsem.SigLIPSemanticEncoder.from_hf_checkpoint(str(tmp_path), device="cpu")
    assert str(got.value) == str(want.value)
    # the trained mini-SigLIP rung, ported since (held to JAX in
    # tests/test_torch_minisiglip.py): it loads, 'cls'-pooled at its canvas
    trained = tsem.SigLIPSemanticEncoder.from_trained_checkpoint("outputs/minisiglip",
                                                                 device="cpu")
    assert isinstance(trained.backend, tsem.TorchSigLIPBackend)
    assert (trained.config.pool_strategy, trained.config.region_resolution) == ("cls", 128)


def test_with_random_tower_runs_on_the_cpu_when_asked():
    encoder = tsem.SigLIPSemanticEncoder.with_random_tower(
        tsem.NaFlexConfig(**NAFLEX), device="cpu", seed=3,
        vision_config=SigLIPVisionConfig(**GEOMETRY))
    assert isinstance(encoder.backend, tsem.FusedSigLIPBackend)
    frame, masks = _frame_and_masks(6, n=3)
    out = encoder.encode_masked_regions(frame, masks)
    assert len(out) == 3 and all(np.isfinite(e.embedding).all() for e in out)
    assert out[0].embedding.shape == (128,)
    with torch.no_grad():
        again = tsem.SigLIPSemanticEncoder.with_random_tower(
            tsem.NaFlexConfig(**NAFLEX), device="cpu", seed=3,
            vision_config=SigLIPVisionConfig(**GEOMETRY)).encode_masked_regions(frame, masks)
    np.testing.assert_array_equal(out[1].embedding, again[1].embedding)


def test_encoder_calibrates_on_the_region_canvases_it_serves():
    """ROADMAP C4: calibrated on noise at the tower's size alone (the JAX
    package's default), the static activation scales clip the attention
    outputs of zero-padded region canvases; the encoder's calibration adds
    padded canvases, and the fused tower then stays with the bf16 tower."""
    vcfg = SigLIPVisionConfig(hidden_size=128, intermediate_size=192, num_layers=2,
                              num_heads=4)     # 384 canvas, 128 regions
    encoder = tsem.SigLIPSemanticEncoder.with_random_tower(
        tsem.NaFlexConfig(quant_fused=True, embedding_dim=128), device="cpu",
        vision_config=vcfg)
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)
    masks = []
    for i in range(6):
        mask = np.zeros((360, 640), bool)
        h, w = rng.integers(20, 150, 2)
        y, x = rng.integers(0, 360 - h), rng.integers(0, 640 - w)
        mask[y:y + h, x:x + w] = True
        masks.append((f"e{i}", mask))
    regions = np.stack(encoder.prepare_regions(frame, masks)[0])
    tower = encoder.backend.tower
    bf16 = tsem.TorchSigLIPBackend(tower)(regions)[1]
    served = _cos(encoder.backend(regions)[1], bf16).min()
    noise = tsem.noise_pixels(4, vcfg.image_size, "cpu")
    noise_only = _cos(tsem.FusedSigLIPBackend(tower, calib_pixels=noise)(regions)[1],
                      bf16).min()
    assert served >= 0.999 and noise_only < served, (served, noise_only)
