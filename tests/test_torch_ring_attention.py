"""gvl_tpu_torch.ops.ring_attention against gvl_tpu.ops.ring_attention.

JAX's ring runs on its 8-device CPU mesh; the port's in one world of four
gloo processes, over a data group of 4 (a 4 x 1 mesh) and of 2 (each
column of a 2 x 2 mesh), each rank holding its slice of the sequence.
Outputs are held at 2e-5 and the gradients of ``sum(out ** 2)`` with
respect to q, k and v at 1e-3, as JAX's own tests hold JAX's ring against
full attention (``tests/test_ring_attention.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gvl_tpu.ops.attention import attention_reference
from gvl_tpu.ops.ring_attention import ring_attention
from gvl_tpu.parallel import build_mesh

import torch_mp_cases as cases
from torch_world import World

OUT_TOL = 2e-5
GRAD_TOL = 1e-3


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


def make_qkv(b=2, h=4, s=256, d=32, seed=0):
    key = jax.random.PRNGKey(seed)
    kq, kk, kv = jax.random.split(key, 3)
    return tuple(np.asarray(jax.random.normal(k, (b, h, s, d))) for k in (kq, kk, kv))


def _whole(per_rank, key, data):
    """The sequence put back together from the ranks of one data group."""
    model = len(per_rank) // data
    return np.concatenate([per_rank[i * model][key] for i in range(data)], axis=2)


@pytest.fixture(scope="module")
def jax_ring():
    """JAX's outputs and (dq, dk, dv) at each causal setting."""
    mesh = build_mesh(8, 1)
    q, k, v = make_qkv()
    out = {}
    for causal in (True, False):
        ring = lambda q, k, v, c=causal: ring_attention(q, k, v, mesh, causal=c)  # noqa: E731
        grads = jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) ** 2), argnums=(0, 1, 2))
        # jitted: eager dispatch of the ring's ops takes twenty times longer
        ring_out, ring_grads = jax.jit(lambda q, k, v: (ring(q, k, v), grads(q, k, v)))(q, k, v)
        out[causal] = (np.asarray(ring_out), [np.asarray(g) for g in ring_grads])
    return out


@pytest.mark.parametrize("data", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_ring_outputs_and_gradients(world, jax_ring, data, causal):
    q, k, v = make_qkv()
    got = world.run(cases.ring, q, k, v, causal, data, 4 // data)
    want, grads = jax_ring[causal]
    np.testing.assert_allclose(_whole(got, "out", data), want, atol=OUT_TOL, rtol=OUT_TOL)
    np.testing.assert_allclose(_whole(got, "out", data),
                               np.asarray(attention_reference(q, k, v, causal=causal)),
                               atol=OUT_TOL, rtol=OUT_TOL)
    for key, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_whole(got, key, data), g, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=key)


def test_gradients_match_full_attention(world):
    """dq, dk and dv against full attention's (JAX's reference), on a
    sequence whose first rows see few keys."""
    q, k, v = make_qkv(b=1, h=2, s=64, d=16, seed=3)
    got = world.run(cases.ring, q, k, v, True, 4, 1)
    grads = jax.grad(lambda q, k, v: jnp.sum(attention_reference(q, k, v, causal=True) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    for key, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_whole(got, key, 4), np.asarray(g), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=key)


def test_causal_first_token_attends_self_only(world):
    q, k, v = make_qkv(s=64)
    got = world.run(cases.ring, q, k, v, True, 4, 1)
    np.testing.assert_allclose(_whole(got, "out", 4)[:, :, 0], v[:, :, 0], atol=1e-5)
