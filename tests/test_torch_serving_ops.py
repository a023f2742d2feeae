"""The serving path's ops and model forms of gvl_tpu_torch against gvl_tpu's,
on the CPU.

The same numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode, as tests/test_decode_attention.py runs them, and their
references) and through the port's plain PyTorch versions, which the
port's wrappers run on CPU tensors: ``chunk_attention``,
``decode_attention_stacked`` and ``cache_append_stacked``; then the model's
``chunk_verify`` forward at per-slot offsets and its ``scan_layers`` form
with weights carried over by ``params_from_jax``.  Tolerances: f32 ops at
2e-5 (sums in another order); model logits at 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models.qwen3 import KVCache as JaxKVCache
from gvl_tpu.models.qwen3 import Qwen3Config as JaxConfig
from gvl_tpu.models.qwen3 import Qwen3Model as JaxModel
from gvl_tpu.ops.cache_update import cache_append_stacked as jax_append_stacked
from gvl_tpu.ops.cache_update import (
    cache_append_stacked_reference as jax_append_stacked_reference,
)
from gvl_tpu.ops.decode_attention import chunk_attention as jax_chunk
from gvl_tpu.ops.decode_attention import (
    chunk_attention_reference as jax_chunk_reference,
)
from gvl_tpu.ops.decode_attention import decode_attention_stacked as jax_stacked
from gvl_tpu.ops.decode_attention import (
    decode_attention_stacked_reference as jax_stacked_reference,
)
from gvl_tpu_torch.models import qwen3 as port
from gvl_tpu_torch.models.convert import params_from_jax
from gvl_tpu_torch.ops.attention import attention_reference
from gvl_tpu_torch.ops.cache_update import (
    cache_append_stacked,
    cache_append_stacked_reference,
)
from gvl_tpu_torch.ops.decode_attention import (
    chunk_attention,
    chunk_attention_reference,
    decode_attention_reference,
    decode_attention_stacked,
    decode_attention_stacked_reference,
)

OP_ATOL = 2e-5
LOGITS_ATOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- chunk (B6)

@pytest.mark.parametrize("hq,hkv,seq,starts", [
    (4, 2, 5, [0, 17]),          # a speculative verify, mixed offsets
    (4, 4, 16, [100, 3]),        # a session delta
    (8, 1, 9, [64, 119]),        # GQA 8, the chunk reaching the cache's end
])
def test_chunk_reference_matches_jax_kernel_and_reference(hq, hkv, seq, starts):
    rng = np.random.default_rng(seq + hq)
    q = _rand(rng, 2, hq, seq, 64)
    k, v = _rand(rng, 2, hkv, 128, 64), _rand(rng, 2, hkv, 128, 64)
    start = np.asarray(starts, np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(start))
    kernel = jax_chunk(*jargs, block_k=32, interpret=True)
    reference = jax_chunk_reference(*jargs)
    got = chunk_attention_reference(_t(q), _t(k), _t(v), _t(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(reference), atol=OP_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=OP_ATOL)
    before = chunk_attention.launches
    assert torch.equal(chunk_attention(_t(q), _t(k), _t(v), _t(start)), got)
    assert chunk_attention.launches == before      # no kernel on the CPU


def test_chunk_at_offset_zero_is_causal_attention():
    rng = np.random.default_rng(1)
    q, k, v = _t(_rand(rng, 2, 4, 12, 16)), _t(_rand(rng, 2, 2, 40, 16)), _t(_rand(rng, 2, 2, 40, 16))
    got = chunk_attention_reference(q, k, v, torch.zeros(2, dtype=torch.int32))
    want = attention_reference(q, k[:, :, :12], v[:, :, :12], causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=OP_ATOL)


def test_chunk_at_offset_equals_tokens_decoded_one_by_one():
    rng = np.random.default_rng(2)
    q = _t(_rand(rng, 2, 4, 6, 16))
    k, v = _t(_rand(rng, 2, 2, 64, 16)), _t(_rand(rng, 2, 2, 64, 16))
    start = torch.tensor([10, 31], dtype=torch.int32)
    got = chunk_attention_reference(q, k, v, start)
    for s in range(6):
        one = decode_attention_reference(q[:, :, s], k, v, start + s + 1)
        np.testing.assert_allclose(got[:, :, s].numpy(), one.numpy(), atol=OP_ATOL)


# ------------------------------------------------------ stacked forms (B4, B5)

@pytest.mark.parametrize("lengths,layer", [([1, 70], 0), ([128, 5], 2)])
def test_decode_stacked_reference_matches_jax(lengths, layer):
    rng = np.random.default_rng(sum(lengths) + layer)
    q = _rand(rng, 2, 4, 128)
    k_all, v_all = _rand(rng, 3, 2, 2, 128, 128), _rand(rng, 3, 2, 2, 128, 128)
    lens = np.asarray(lengths, np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all),
             jnp.asarray(lens), jnp.int32(layer))
    kernel = jax_stacked(*jargs, block_k=32, interpret=True)
    reference = jax_stacked_reference(*jargs)
    got = decode_attention_stacked_reference(_t(q), _t(k_all), _t(v_all),
                                             _t(lens), layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(reference), atol=OP_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=OP_ATOL)
    before = decode_attention_stacked.launches
    assert torch.equal(decode_attention_stacked(_t(q), _t(k_all), _t(v_all),
                                                _t(lens), layer), got)
    assert decode_attention_stacked.launches == before


@pytest.mark.parametrize("positions,layer", [([0, 7, 63], 1), ([8, 56, 1], 0)])
def test_append_stacked_reference_matches_jax(positions, layer):
    rng = np.random.default_rng(layer)
    cache, new = _rand(rng, 2, 3, 2, 64, 128), _rand(rng, 3, 2, 128)
    pos = np.asarray(positions, np.int32)
    jargs = (jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos), jnp.int32(layer))
    kernel = jax_append_stacked(*jargs, interpret=True)
    reference = jax_append_stacked_reference(*jargs)
    got = cache_append_stacked_reference(_t(cache), _t(new), _t(pos), layer)
    np.testing.assert_array_equal(got.numpy(), np.asarray(reference))
    np.testing.assert_array_equal(got.numpy(), np.asarray(kernel))
    before = cache_append_stacked.launches
    src = _t(cache)
    out = cache_append_stacked(src, _t(new), _t(pos), layer)
    assert torch.equal(out, got) and torch.equal(src, _t(cache))   # a copy
    assert cache_append_stacked.launches == before


def test_append_stacked_drops_out_of_range_positions():
    cache = torch.zeros(2, 2, 1, 8, 16)
    out = cache_append_stacked_reference(cache, torch.ones(2, 1, 16),
                                         torch.tensor([8, -1]), 1)
    assert torch.equal(out, cache)


# ---------------------------------------------------------------- the model

def _pair(**kw):
    jcfg = JaxConfig.tiny(**kw)
    tcfg = port.Qwen3Config.tiny(**kw)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    state = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, state


@pytest.mark.parametrize("head_dim", [16, 128])
def test_chunk_verify_logits_at_per_slot_offsets_match_jax(head_dim):
    """Two slots holding cached prefixes of 9 and 30 rows take a 6-token chunk
    each at their own offset: logits and the written cache rows equal."""
    jcfg, tcfg, params, state = _pair(head_dim=head_dim, chunk_verify=True)
    rng = np.random.default_rng(3)
    starts = np.asarray([9, 30], np.int32)
    shape = (2, tcfg.num_kv_heads, tcfg.max_cache_length, head_dim)
    ks = [_rand(rng, *shape) for _ in range(tcfg.num_layers)]
    vs = [_rand(rng, *shape) for _ in range(tcfg.num_layers)]
    tokens = rng.integers(0, 512, (2, 6)).astype(np.int32)
    positions = starts[:, None] + np.arange(6, dtype=np.int32)[None]

    jcache = JaxKVCache(k=tuple(map(jnp.asarray, ks)), v=tuple(map(jnp.asarray, vs)),
                        length=jnp.asarray(starts))
    want, jcache = JaxModel(jcfg).apply(params, jnp.asarray(tokens),
                                        positions=jnp.asarray(positions),
                                        cache=jcache)
    model = port.load_model(tcfg, state, "cpu")
    cache = port.KVCache([_t(x) for x in ks], [_t(x) for x in vs], starts.tolist())
    with torch.no_grad():
        got, cache = model(_t(tokens).long(), positions=_t(positions), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)
    assert cache.lengths == np.asarray(jcache.length).tolist() == [15, 36]
    for i in range(tcfg.num_layers):
        np.testing.assert_allclose(cache.k[i].numpy(), np.asarray(jcache.k[i]),
                                   atol=LOGITS_ATOL)


def test_params_from_jax_takes_a_scan_tree_in_either_layout():
    jcfg, tcfg, params, _ = _pair(scan_layers=True)
    tree = jax.tree.map(np.asarray, params)
    stacked = params_from_jax(tree, tcfg)
    unrolled = params_from_jax(tree, dataclasses.replace(tcfg, scan_layers=False))
    kernel = tree["params"]["layers"]["layer"]["self_attn"]["q_proj"]["base"]["kernel"]
    assert stacked["layers.self_attn.q_proj.weight"].shape == (2, 64, 64)
    np.testing.assert_array_equal(stacked["layers.self_attn.q_proj.weight"][1].numpy(),
                                  kernel[1].T)
    assert torch.equal(unrolled["layers.1.mlp.up_proj.weight"],
                       stacked["layers.mlp.up_proj.weight"][1])
    assert port.stack_layers(unrolled, tcfg).keys() == stacked.keys()


@pytest.mark.parametrize("head_dim", [16, 128])
def test_scan_layers_logits_match_jax(head_dim):
    """A JAX scan tree through params_from_jax: teacher-forced logits, then a
    prefill into the stacked cache and 4 decode steps at per-slot lengths
    (head_dim 128 takes the stacked append and decode forms)."""
    jcfg, tcfg, params, state = _pair(head_dim=head_dim, scan_layers=True)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 512, (2, 10)).astype(np.int32)
    jmodel = JaxModel(jcfg)
    model = port.load_model(tcfg, state, "cpu")
    want, _ = jmodel.apply(params, jnp.asarray(prompt))
    with torch.no_grad():
        got, _ = model(_t(prompt).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)

    jcache = JaxKVCache.zeros(jcfg, 2, jnp.float32)
    _, jcache = jmodel.apply(params, jnp.asarray(prompt), cache=jcache)
    # per-slot lengths: slot 1 drops its last 3 prompt rows
    jcache = jcache._replace(length=jnp.asarray([10, 7], jnp.int32))
    cache = port.KVCache.zeros(tcfg, 2, dtype=torch.float32, device="cpu")
    assert cache.stacked and cache.k.shape == (2, 2, 2, 128, head_dim)
    with torch.no_grad():
        model(_t(prompt).long(), cache=cache)
        cache.lengths = [10, 7]
        token = rng.integers(0, 512, (2,)).astype(np.int32)
        for _ in range(4):
            lens = np.asarray(jcache.length)
            want, jcache = jmodel.apply(params, jnp.asarray(token[:, None]),
                                        positions=jnp.asarray(lens[:, None]),
                                        cache=jcache)
            got, cache = model(_t(token[:, None]).long(),
                               positions=_t(lens[:, None]), cache=cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)
            token = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)
    assert cache.lengths == np.asarray(jcache.length).tolist() == [14, 11]
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=LOGITS_ATOL)


def test_stacked_decode_runs_the_stacked_forms(monkeypatch):
    """scan_layers + head_dim 128 + one token: each layer appends K and V
    into the stacked caches in one call and reads them by layer index;
    head_dim 16 does not."""
    calls = []
    real_append, real_decode = port.cache_append_stacked_kv, port.decode_attention_stacked

    def append(k_cache, v_cache, k_new, v_new, positions, layer):
        calls.append(("append", layer))
        return real_append(k_cache, v_cache, k_new, v_new, positions, layer)

    def decode(q, k_all, v_all, lengths, layer):
        calls.append(("decode", layer))
        return real_decode(q, k_all, v_all, lengths, layer)

    monkeypatch.setattr(port, "cache_append_stacked_kv", append)
    monkeypatch.setattr(port, "decode_attention_stacked", decode)
    for head_dim, expect in [(128, [("append", 0), ("decode", 0),
                                    ("append", 1), ("decode", 1)]),
                             (16, [])]:
        calls.clear()
        _, tcfg, _, state = _pair(head_dim=head_dim, scan_layers=True)
        engine = port.Qwen3Engine(tcfg, state, eos_token_id=-1, device="cpu")
        engine.generate([1, 2, 3], max_new_tokens=2, temperature=0.0)
        assert calls == expect * 2 if expect else calls == []


def test_kv_cache_full_raises_instead_of_clamping():
    _, tcfg, _, state = _pair(chunk_verify=True, max_cache_length=32)
    model = port.load_model(tcfg, state, "cpu")
    cache = port.KVCache.zeros(tcfg, 2, dtype=torch.float32, device="cpu")
    cache.lengths = [0, 28]
    with torch.no_grad(), pytest.raises(ValueError, match="KV cache full"):
        model(torch.ones(2, 5, dtype=torch.long),
              positions=torch.arange(5)[None] + torch.tensor([[0], [28]]),
              cache=cache)
    assert cache.lengths == [0, 28]
