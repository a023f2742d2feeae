"""Data-parallel perception in gvl_tpu_torch against gvl_tpu, on the CPU.

The port's segmenter and SigLIP backends run in one world of two gloo
processes with ``mesh=`` (frames padded to a multiple of the data size,
split over ``data``, results gathered on every rank);
each is held to its one-rank run on the same weights and to JAX's single
backend (JAX's own tests, ``tests/test_parallel.py``, hold its
data-parallel backends to its single ones).  The module's world of two
also serves the batching engine's chat turns at 1 x 2 (tensor-parallel
alone; 2 x 2: ``tests/test_torch_multichip.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models import qwen3 as jq
from gvl_tpu.models.siglip import SigLIPVisionConfig as JaxConfig
from gvl_tpu.models.siglip import SigLIPVisionTower as JaxTower
from gvl_tpu.perception import segmenter as jseg
from gvl_tpu.perception import semantic as jsem
from gvl_tpu_torch.config import load_preset
from gvl_tpu_torch.models import qwen3 as tq
from gvl_tpu_torch.models.convert import (
    params_to_jax,
    sam_params_from_jax,
    siglip_params_from_jax,
)
from gvl_tpu_torch.models.sam import SamConfig as PortSamConfig
from gvl_tpu_torch.models.siglip import SigLIPVisionConfig
from gvl_tpu_torch.perception import segmenter as tseg

import torch_mp_cases as cases
from torch_world import World

GEOMETRY = dict(hidden_size=128, intermediate_size=192, num_layers=2, num_heads=4,
                image_size=56)
SCORE_TOL = 1e-4
EMBED_TOL = 1e-4


@pytest.fixture(scope="module")
def world():
    w = World(2)
    yield w
    w.close()


def _frames(n, seed=0, shape=(48, 64, 3)):
    return [np.random.RandomState(seed + i).randint(0, 255, shape).astype(np.uint8)
            for i in range(n)]


def _box(b):
    return (b.x_min, b.y_min, b.x_max, b.y_max)


def _dets(out):
    return [[[(d["mask"].confidence, _box(d["mask"].bbox), d["mask"].area_pixels)
              for d in c] for c in f] for f in out]


def _same_detections(got, want, tol=SCORE_TOL):
    assert len(got) == len(want)
    for fg, fw in zip(got, want):
        for cg, cw in zip(fg, fw):
            assert [d[1:] for d in cg] == [tuple(d[1:]) for d in cw]
            np.testing.assert_allclose([d[0] for d in cg], [d[0] for d in cw], atol=tol)


def test_segmenter_dp_matches_one_rank_and_jax(world):
    """Three frames (padded to 4) x two concepts at the JAX dry run's
    64-pixel geometry: the detections of every rank equal the
    one-rank run's and JAX's backend's (scores within 1e-4)."""
    import torch

    from gvl_tpu_torch.training.init_laws import draw_tree, sam_layout

    seg_cfg = jseg.SAMConfig(image_size=64, detection_threshold=0.0)
    # JAX's tree drawn by Flax's laws without a JAX compile
    variables = draw_tree(sam_layout(PortSamConfig(image_size=64)),
                          torch.Generator().manual_seed(0))
    single = jseg.JaxSegmenterBackend(seg_cfg, variables=variables)
    frames, concepts = _frames(3), ["player", "enemy"]
    want = _dets(single(frames, concepts, list(range(3))))
    assert any(c for f in want for c in f)
    state = sam_params_from_jax(jax.tree.map(np.asarray, variables),
                                PortSamConfig(image_size=64))
    port_cfg = tseg.SAMConfig(image_size=64, detection_threshold=0.0)
    alone = cases.segment(port_cfg, state, 1, frames, concepts)
    _same_detections(alone, want)
    for got in world.run(cases.segment, port_cfg, state, 2, frames, concepts):
        _same_detections(got, alone)


@pytest.fixture(scope="module")
def tower():
    jcfg = JaxConfig(**GEOMETRY)
    params = jax.jit(JaxTower(jcfg).init)(jax.random.PRNGKey(4),
                                          jnp.ones((1, 56, 56, 3)))["params"]
    state = siglip_params_from_jax(jax.tree.map(np.asarray, params), jcfg.num_layers)
    return jcfg, params, SigLIPVisionConfig(**GEOMETRY), state


@pytest.mark.parametrize("pool", ["mean", "cls"])
def test_siglip_dp_matches_one_rank_and_jax(world, tower, pool):
    """The f32 tower backend on 7 images: every rank's embeddings equal the
    one-rank run's within 1e-5 and JAX's within 1e-4."""
    jcfg, params, vcfg, state = tower
    batch = np.random.default_rng(5).integers(0, 256, (7, 56, 56, 3), dtype=np.uint8)
    want = jsem.JaxSigLIPBackend(JaxTower(jcfg), {"params": params}, dtype="float32",
                                 pool_strategy=pool)(batch)[1]
    alone = cases.siglip(vcfg, state, 1, batch, False, pool)
    np.testing.assert_allclose(alone, want, atol=EMBED_TOL, rtol=EMBED_TOL)
    for got in world.run(cases.siglip, vcfg, state, 2, batch, False, pool):
        assert got.shape == (7, GEOMETRY["hidden_size"])
        np.testing.assert_allclose(got, alone, atol=1e-5, rtol=1e-5)


def _cos(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return (a * b).sum(-1)


def test_fused_siglip_dp_matches_one_rank_and_jax(world, tower):
    """The fused W8A8 tower (plain versions of B7-B10 here) on 6 images:
    every rank's pooled embeddings at cosine 0.99999 or more to the
    one-rank run's (phase 20's bound) and 0.999 to JAX's fused backend."""
    import torch

    from gvl_tpu_torch.perception.semantic import noise_pixels

    jcfg, params, vcfg, state = tower
    state = {k: v.to(torch.bfloat16) for k, v in state.items()}
    batch = np.random.default_rng(6).integers(0, 256, (6, 56, 56, 3), dtype=np.uint8)
    calib = noise_pixels(4, 56, "cpu").numpy()
    want = jsem.FusedSigLIPBackend(
        JaxTower(jcfg), {"params": jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)},
        calib_pixels=jnp.asarray(calib))(batch)[1]
    alone = cases.siglip(vcfg, state, 1, batch, True)
    assert _cos(alone, want).min() >= 0.999
    for got in world.run(cases.siglip, vcfg, state, 2, batch, True):
        assert _cos(got, alone).min() >= 0.99999


def test_lockstep_sessions_match_jax_at_1x2(world):
    """C18 at 1 x 2: chat turns in the engine's step on both ranks give
    JAX's session tokens and prefilled counts, with one eviction; both
    ranks keep the same table and transcripts."""
    from test_torch_multichip import PROMPTS, jax_sessions
    from test_torch_tensor_parallel import KW

    # Flax's laws drawn by the port (no JAX compile), carried into JAX's tree
    # as copies: sending the state to the world moves its tensors' storage
    jcfg, tcfg = jq.Qwen3Config.tiny(**KW), tq.Qwen3Config.tiny(**KW)
    state = tq.init_jax_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    params = jax.tree.map(np.copy, params_to_jax(state, tcfg))
    alone, = cases.lockstep_sessions(tcfg, state, 1, 1, PROMPTS, 5)
    got = [out for out, in world.run(cases.lockstep_sessions, tcfg, state, 1, 2, PROMPTS, 5)]
    assert got[0]["turns"] == jax_sessions(jcfg, params, PROMPTS, 5) == alone["turns"]
    assert [o["tables"] for o in got] == [alone["tables"]] * 2
    assert [o["cached"] for o in got] == [alone["cached"]] * 2
    assert [o["generated"] for o in got] == [alone["generated"]] * 2


def test_perception_stack_builders_take_the_mesh(world):
    """``build_perception_stack(mesh=)`` with the segmenter's model rung
    (seeded weights at its trained geometry) and the bf16 so400m-free
    fake encoder: the same detections at data 2 as on one rank."""
    preset = load_preset("light")
    preset.perception.sam_backend = "jax"
    preset.perception.siglip_backend = "fake"
    frames = _frames(3, seed=7, shape=(72, 96, 3))
    alone = cases.stack_builders(preset, 1, frames)
    for got in world.run(cases.stack_builders, preset, 2, frames):
        assert got[0] == alone[0]
        np.testing.assert_array_equal(got[1], alone[1])
