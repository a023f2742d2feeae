"""gvl_tpu_torch's SigLIP vision tower, W8A8 projection and fused W8A8 tower
against gvl_tpu's, on the CPU.

Weights made by the JAX package are carried across with
``siglip_params_from_jax`` / ``fused_from_jax``.  Geometry: hidden 128, FFN
192, 4 heads (tests/test_quant_fused.py:133): ``tiny()``'s hidden 64 is not
a multiple of 128, which the int8 product needs.  Tolerances: the f32 tower
within 1e-4; int8 weights equal; calibrated activation scales within 1e-6
relative (the observed amax is an f32 max of sums taken in another order);
the fused tower's pooled output at cosine >= 0.999 against JAX's on the
same fused tree (int8 requantize boundaries may fall one step apart).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models import siglip as jsig
from gvl_tpu.models import siglip_fused as jfused
from gvl_tpu.nn.quant import W8A8Dense as JaxW8A8Dense
from gvl_tpu.ops import quant_matmul as jquant
from gvl_tpu.nn.quant import quantize_kernels_int8 as jax_quantize
from gvl_tpu_torch.models import siglip as tsig
from gvl_tpu_torch.models import siglip_fused as tfused
from gvl_tpu_torch.models.convert import fused_from_jax, siglip_params_from_jax
from gvl_tpu_torch.nn.quant import W8A8Dense, quantize_kernel_int8

GEOMETRY = dict(hidden_size=128, intermediate_size=192, num_layers=2, num_heads=4,
                image_size=56)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def towers():
    """(JAX config, port config, JAX params, port state, pixels)."""
    jcfg, tcfg = jsig.SigLIPVisionConfig(**GEOMETRY), tsig.SigLIPVisionConfig(**GEOMETRY)
    params = jsig.SigLIPVisionTower(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 56, 56, 3)))["params"]
    state = siglip_params_from_jax(_np_tree(params), jcfg.num_layers)
    pixels = np.random.default_rng(0).uniform(0, 1, (2, 56, 56, 3)).astype(np.float32)
    return jcfg, tcfg, params, state, pixels


@pytest.fixture(scope="module")
def calibrated(towers):
    """The JAX package's quantized + calibrated tree and the port's."""
    jcfg, tcfg, params, state, pixels = towers
    jq = jsig.calibrate_siglip_int8(jcfg, jsig.quantize_siglip_int8(params),
                                    jnp.asarray(pixels))
    tq = tsig.calibrate_siglip_int8(tcfg, tsig.quantize_siglip_int8(state),
                                    torch.from_numpy(pixels))
    return jq, tq


@pytest.mark.parametrize("shape", [(2, 56, 56), (1, 28, 28), (1, 84, 84), (1, 42, 98)])
def test_f32_tower_matches_jax(towers, shape):
    """The tower in f32 with carried weights; off-size canvases take the
    bilinear resize of the position grid (down, up and non-square)."""
    jcfg, tcfg, params, state, _ = towers
    pixels = np.random.default_rng(sum(shape)).uniform(0, 1, (*shape, 3)).astype(np.float32)
    want = jsig.SigLIPVisionTower(jcfg).apply({"params": params}, jnp.asarray(pixels))
    with torch.no_grad():
        got = tsig.load_tower(tcfg, state, "cpu")(torch.from_numpy(pixels))
    for key in ("last_hidden_state", "pooled"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, rtol=1e-4)


def test_pos_embed_resize_matches_jax_image_resize():
    grid = np.random.default_rng(1).normal(size=(27 * 27, 64)).astype(np.float32)
    for nh, nw in ((9, 9), (2, 2), (40, 40), (27, 13)):
        want = jax.image.resize(jnp.asarray(grid).reshape(27, 27, 64), (nh, nw, 64),
                                "bilinear").reshape(nh * nw, 64)
        got = tsig.resize_pos_embed(torch.from_numpy(grid), 27, nh, nw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("static", [False, True])
def test_w8a8_dense_matches_jax(static):
    rng = np.random.default_rng(2)
    kernel = (rng.normal(size=(256, 192)) * 0.05).astype(np.float32)
    bias = (rng.normal(size=192) * 0.1).astype(np.float32)
    x = rng.normal(size=(3, 17, 256)).astype(np.float32)
    jparams = jax_quantize({"proj": {"kernel": kernel, "bias": bias}}, ("proj",))["proj"]
    q, scale = quantize_kernel_int8(torch.from_numpy(kernel))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jparams["kernel_q"]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jparams["scale"]))
    if static:
        jparams = dict(jparams, act_scale=jnp.float32(0.031))
    want = JaxW8A8Dense(192, static_act=static).apply({"params": jparams}, jnp.asarray(x))
    dense = W8A8Dense(256, 192, static_act=static)
    dense.kernel_q, dense.scale, dense.bias = q, scale, torch.from_numpy(bias)
    if static:
        dense.act_scale = torch.tensor(np.float32(0.031))
    got = dense(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_calibration_scales_match_jax(towers, calibrated):
    jcfg = towers[0]
    jq, tq = calibrated
    for i in range(jcfg.num_layers):
        for group, names in (("attention", ("q_proj", "k_proj", "v_proj", "o_proj")),
                             ("mlp", ("fc1", "fc2"))):
            for name in names:
                node = jq[f"layers_{i}"][group][name]
                prefix = f"layers.{i}.{group}.{name}."
                np.testing.assert_array_equal(tq[prefix + "kernel_q"].numpy(),
                                              np.asarray(node["kernel_q"]))
                np.testing.assert_allclose(tq[prefix + "act_scale"].item(),
                                           float(node["act_scale"]), rtol=1e-6)


def test_static_w8a8_tower_matches_jax(towers, calibrated):
    """The XLA-composed static-activation W8A8 tower, in f32."""
    jcfg, tcfg, _, _, pixels = towers
    jq, _ = calibrated
    qcfg = dict(quant_int8=True, quant_static_act=True)
    want = jsig.SigLIPVisionTower(dataclasses.replace(jcfg, **qcfg)).apply(
        {"params": jq}, jnp.asarray(pixels))
    state = siglip_params_from_jax(_np_tree(jq), jcfg.num_layers)
    with torch.no_grad():
        got = tsig.load_tower(dataclasses.replace(tcfg, **qcfg), state, "cpu")(
            torch.from_numpy(pixels))
    assert _cos(got["pooled"].numpy(), want["pooled"]).min() >= 0.9999


@pytest.mark.parametrize("packed,int8_attention", [
    pytest.param(False, False, id="False"), pytest.param(True, False, id="True"),
    pytest.param(False, True, id="int8_attention"),
    pytest.param(True, True, id="packed-int8_attention")])
def test_fused_tower_matches_jax_on_the_same_tree(towers, calibrated, packed, int8_attention,
                                                  monkeypatch):
    """With ``int8_attention`` JAX's padded attention runs its Pallas body in
    interpret mode (its XLA reference, which the CPU takes, has no
    int8_scores)."""
    jcfg, tcfg, _, _, pixels = towers
    jq, _ = calibrated
    if int8_attention:
        monkeypatch.setattr(jfused, "attention_fused_qkv", functools.partial(
            jquant.attention_fused_qkv_pallas, interpret=True))
    jtree = jfused.fuse_siglip_int8(jq, jcfg, packed_attention=packed)
    want = jfused.siglip_fused_apply(jtree, jnp.asarray(pixels), jcfg,
                                     int8_attention=int8_attention)
    tree = fused_from_jax(_np_tree(jtree))
    got = tfused.siglip_fused_apply(tree, torch.from_numpy(pixels), tcfg,
                                    int8_attention=int8_attention)
    assert got["last_hidden_state"].dtype == torch.bfloat16
    assert _cos(got["pooled"].float().numpy(),
                np.asarray(want["pooled"], np.float32)).min() >= 0.999
    g = got["last_hidden_state"].float().numpy()
    w = np.asarray(want["last_hidden_state"], np.float32)
    assert _cos(g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])).min() >= 0.999
    if int8_attention:
        # the packed layout ignores the flag (as JAX's does); the padded one
        # takes B9's int8_scores mode, which moves the output
        plain = tfused.siglip_fused_apply(tree, torch.from_numpy(pixels), tcfg)
        assert torch.equal(got["last_hidden_state"], plain["last_hidden_state"]) == packed


def test_port_fuse_step_matches_jax(towers, calibrated):
    """The port's own fuse of its own calibration gives JAX's fused tree."""
    jcfg, tcfg, _, _, _ = towers
    jq, tq = calibrated
    want = fused_from_jax(_np_tree(jfused.fuse_siglip_int8(jq, jcfg)))
    got = tfused.fuse_siglip_int8(tq, tcfg)
    for lw, lg in zip(want["layers"], got["layers"]):
        assert lw.keys() == lg.keys()
        for key, value in lw.items():
            if isinstance(value, float):
                assert lg[key] == pytest.approx(value, rel=1e-6)
            elif value.dtype == torch.int8:
                assert torch.equal(lg[key], value), key
            else:
                torch.testing.assert_close(lg[key], value, rtol=1e-6, atol=0)


def test_packed_fused_tower_matches_padded(towers, calibrated):
    _, tcfg, _, _, pixels = towers
    _, tq = calibrated
    x = torch.from_numpy(pixels)
    padded = tfused.siglip_fused_apply(tfused.fuse_siglip_int8(tq, tcfg), x, tcfg)
    packed = tfused.siglip_fused_apply(
        tfused.fuse_siglip_int8(tq, tcfg, packed_attention=True), x, tcfg)
    assert _cos(packed["pooled"].float().numpy(),
                padded["pooled"].float().numpy()).min() >= 0.999


def test_fused_off_size_bucket_matches_jax(towers, calibrated):
    """A 28 x 28 canvas on a 56-pixel tower: the f32 resize of the position
    grid inside the fused apply."""
    jcfg, tcfg, _, _, _ = towers
    jq, _ = calibrated
    jtree = jfused.fuse_siglip_int8(jq, jcfg)
    pixels = np.random.default_rng(3).uniform(0, 1, (2, 28, 28, 3)).astype(np.float32)
    want = jfused.siglip_fused_apply(jtree, jnp.asarray(pixels), jcfg)
    got = tfused.siglip_fused_apply(fused_from_jax(_np_tree(jtree)),
                                    torch.from_numpy(pixels), tcfg)
    assert got["pooled"].shape == (2, 128)
    assert np.isfinite(got["pooled"].float().numpy()).all()
    assert _cos(got["pooled"].float().numpy(),
                np.asarray(want["pooled"], np.float32)).min() >= 0.999


def test_fused_plain_switch_is_the_cpu_path(towers, calibrated):
    """``kernels=False`` (the plain path the card run compares with) is what
    the wrappers run on CPU tensors."""
    _, tcfg, _, _, pixels = towers
    _, tq = calibrated
    tree, x = tfused.fuse_siglip_int8(tq, tcfg), torch.from_numpy(pixels)
    a = tfused.siglip_fused_apply(tree, x, tcfg)["pooled"]
    b = tfused.siglip_fused_apply(tree, x, tcfg, kernels=False)["pooled"]
    assert torch.equal(a, b)
