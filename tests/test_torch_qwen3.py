"""gvl_tpu_torch Qwen3 decoder against gvl_tpu's, on the CPU.

Weights made by the JAX model (or read from ``outputs/qa_lm``) are carried
across with ``params_from_jax``; logits are compared in f32 and greedy
tokens must be identical with an f32 cache.  The JAX model runs its plain
XLA paths on the CPU, as its own tests do.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models.qwen3 import KVCache as JaxKVCache
from gvl_tpu.models.qwen3 import Qwen3Config as JaxConfig
from gvl_tpu.models.qwen3 import Qwen3Engine as JaxEngine
from gvl_tpu.models.qwen3 import Qwen3Model as JaxModel
from gvl_tpu_torch.models import qwen3 as port
from gvl_tpu_torch.models.convert import params_from_jax

# f32 sums over the hidden and head axes in another order, through 2 layers
TINY_LOGITS_ATOL = 5e-5
# the real 62M model: 10 layers, hidden 640, 256 positions
QA_LOGITS_ATOL = 1e-3
QA_CKPT = Path(__file__).resolve().parents[1] / "outputs" / "qa_lm"


def _tiny_pair(**kw):
    jcfg = JaxConfig.tiny(**kw)
    tcfg = port.Qwen3Config.tiny(**kw)
    tokens = jnp.ones((1, 8), jnp.int32)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0), tokens)
    state = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, state


def test_config_has_every_jax_field():
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name for f in dataclasses.fields(port.Qwen3Config)}
    assert jax_fields <= port_fields
    assert port.Qwen3Config().hidden_size == JaxConfig().hidden_size


@pytest.mark.parametrize("head_dim,tied", [(16, False), (128, False), (16, True)])
def test_tiny_teacher_forced_logits_match(head_dim, tied):
    jcfg, tcfg, params, state = _tiny_pair(head_dim=head_dim, tie_word_embeddings=tied)
    tokens = np.random.default_rng(0).integers(0, 512, (2, 19)).astype(np.int32)
    want, _ = JaxModel(jcfg).apply(params, jnp.asarray(tokens))
    engine = port.Qwen3Engine(tcfg, state, device="cpu")
    with torch.no_grad():
        got, _ = engine.model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TINY_LOGITS_ATOL)


@pytest.mark.parametrize("head_dim", [16, 128])
def test_tiny_cached_prefill_and_decode_logits_match(head_dim):
    """Prefill into the cache, then 8 single-token steps, logits each step."""
    jcfg, tcfg, params, state = _tiny_pair(head_dim=head_dim)
    prompt = np.random.default_rng(1).integers(0, 512, (1, 12)).astype(np.int32)
    jmodel = JaxModel(jcfg)
    jcache = JaxKVCache.zeros(jcfg, 1, jnp.float32)
    jlogits, jcache = jmodel.apply(params, jnp.asarray(prompt), cache=jcache)
    model = port.Qwen3Engine(tcfg, state, device="cpu").model
    cache = port.KVCache.zeros(tcfg, 1, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        tlogits, cache = model(torch.from_numpy(prompt).long(), cache=cache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=TINY_LOGITS_ATOL)
        token = int(np.argmax(np.asarray(jlogits)[0, -1]))
        for _ in range(8):
            jlogits, jcache = jmodel.apply(
                params, jnp.asarray([[token]], jnp.int32),
                positions=jcache.length[None], cache=jcache)
            tlogits, cache = model(
                torch.tensor([[token]]),
                positions=torch.tensor([cache.length]), cache=cache)
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                       atol=TINY_LOGITS_ATOL)
            assert int(tlogits[0, -1].argmax()) == int(np.argmax(np.asarray(jlogits)[0, -1]))
            token = int(np.argmax(np.asarray(jlogits)[0, -1]))
    assert cache.length == int(jcache.length) == 20


@pytest.mark.parametrize("head_dim", [16, 128])
def test_tiny_greedy_tokens_identical(head_dim):
    jcfg, tcfg, params, state = _tiny_pair(head_dim=head_dim)
    prompt = [7, 3, 99, 150, 2]
    want = JaxEngine(jcfg, params, eos_token_id=-1, dtype=jnp.float32).generate(
        prompt, max_new_tokens=8, temperature=0.0)
    got = port.Qwen3Engine(tcfg, state, eos_token_id=-1, dtype=torch.float32,
                           device="cpu").generate(prompt, max_new_tokens=8,
                                                  temperature=0.0)
    assert got == want and len(got) == 8


@pytest.mark.parametrize("head_dim,appends", [(4, 0), (16, 2 * 8), (128, 2 * 8)])
def test_cache_append_branch_only_at_head_dim_128(monkeypatch, head_dim, appends):
    """The JAX model (qwen3.py:283) takes its append kernel for d % 128 == 0
    only, the TPU's lane width; the port takes its pair kernel wherever the
    Hopper kernel takes the row: a multiple of 16 bytes (bf16 cache: d 16
    and 128, not d 4), K and V in one call per layer."""
    _, tcfg, _, state = _tiny_pair(head_dim=head_dim)
    calls = []
    real = port.cache_append_kv

    def counting(k_cache, v_cache, k_new, v_new, positions):
        calls.append(int(positions[0]))
        return real(k_cache, v_cache, k_new, v_new, positions)

    monkeypatch.setattr(port, "cache_append_kv", counting)
    port.Qwen3Engine(tcfg, state, eos_token_id=-1, device="cpu").generate(
        [1, 2, 3], max_new_tokens=8, temperature=0.0)
    # 2 layers x 8 decode steps, written at positions 3 .. 10
    assert len(calls) == appends
    if appends:
        assert sorted(set(calls)) == list(range(3, 11))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_qa_shaped_decode_writes_one_pair_per_layer(monkeypatch, cache_dtype):
    """A QA-shaped model (head_dim 64, f32 weights, the QA model's 2:1
    heads) gives JAX's greedy tokens; every decode step writes each layer's
    K and V through one pair call, f32 rows into a bf16 cache included."""
    kw = dict(head_dim=64, num_heads=4, num_kv_heads=2, hidden_size=128, num_layers=3)
    jcfg, tcfg, params, state = _tiny_pair(**kw)
    want = JaxEngine(jcfg, params, eos_token_id=-1, dtype=getattr(jnp, cache_dtype)).generate(
        [5, 9, 2, 7], max_new_tokens=10, temperature=0.0)
    calls = []
    real = port.cache_append_kv

    def counting(k_cache, v_cache, k_new, v_new, positions):
        calls.append((k_new.dtype, k_cache.dtype, int(positions[0])))
        return real(k_cache, v_cache, k_new, v_new, positions)

    monkeypatch.setattr(port, "cache_append_kv", counting)
    got = port.Qwen3Engine(tcfg, state, eos_token_id=-1, device="cpu",
                           dtype=getattr(torch, cache_dtype)).generate(
        [5, 9, 2, 7], max_new_tokens=10, temperature=0.0)
    assert got == want and len(got) == 10
    # 3 layers x 10 decode steps, f32 rows uncast, at positions 4 .. 13
    assert len(calls) == 3 * 10
    assert {c[:2] for c in calls} == {(torch.float32, getattr(torch, cache_dtype))}
    assert sorted({c[2] for c in calls}) == list(range(4, 14))


def test_engine_bucket_and_eos_stop():
    _, tcfg, _, state = _tiny_pair()
    engine = port.Qwen3Engine(tcfg, state, eos_token_id=-1, dtype=torch.float32,
                              device="cpu")
    assert [engine._bucket(n) for n in (1, 128, 129, 500)] == [128, 128, 128, 128]
    first = engine.generate([4, 5, 6], max_new_tokens=3, temperature=0.0)
    engine.eos_token_id = first[1]
    assert engine.generate([4, 5, 6], max_new_tokens=3, temperature=0.0) == first[:1]


def test_embeds_prefix_matches_jax():
    jcfg, tcfg, params, state = _tiny_pair()
    prefix = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    want = JaxEngine(jcfg, params, eos_token_id=-1, dtype=jnp.float32).generate(
        [5, 6, 7], max_new_tokens=6, temperature=0.0, inputs_embeds_prefix=prefix)
    got = port.Qwen3Engine(tcfg, state, eos_token_id=-1, dtype=torch.float32,
                           device="cpu").generate(
        [5, 6, 7], max_new_tokens=6, temperature=0.0, inputs_embeds_prefix=prefix)
    assert got == want


def test_sampling_keeps_top_k():
    logits = torch.tensor([[0.0, 5.0, 4.0, -3.0, 1.0]])
    gen = torch.Generator().manual_seed(0)
    picks = {int(port.sample_logits(logits, gen, temperature=1.0, top_p=1.0, top_k=2))
             for _ in range(50)}
    assert picks <= {1, 2}
    assert int(port.sample_logits(logits, temperature=0.0)) == 1


def test_unported_options_raise(tmp_path):
    """int8 and LoRA, refused before they were ported, now build with the
    JAX model's parameters (their logits: ``tests/test_torch_lora_int8.py``);
    so does the HF rung (ROADMAP A10's reasoning half): ``load_hf_qwen3``
    reads a saved HF directory into JAX's config and weights (more in
    ``tests/test_torch_hf_qwen3.py``)."""
    _, tcfg, params, _ = _tiny_pair(quant_int8=True, lora_rank=4)
    names = set(port.Qwen3Model(tcfg).state_dict())
    jax_leaves = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(params)}
    assert {"lm_head.weight_q", "lm_head.scale", "layers.1.self_attn.q_proj.weight_q",
            "layers.1.mlp.down_proj.lora_a", "layers.1.mlp.down_proj.lora_b"} <= names
    assert not any(n.endswith("proj.weight") for n in names)
    assert len(names) == len(jax_leaves)
    stacked = port.Qwen3Model(port.Qwen3Config.tiny(quant_int8=True, scan_layers=True))
    assert stacked.layers.mlp.up_proj.weight_q.shape == (2, 128, 64)
    assert stacked.layers.mlp.up_proj.scale.shape == (2, 128)
    # scan_layers and chunk_verify are ported
    for kw in ({"scan_layers": True}, {"chunk_verify": True}):
        port.Qwen3Model(port.Qwen3Config.tiny(**kw))
    from gvl_tpu.models.qwen3 import load_hf_qwen3 as jax_load_hf

    from test_torch_hf_qwen3 import save_tiny_qwen3

    path = save_tiny_qwen3(tmp_path / "hf", tokenizer=False)
    hf_cfg, hf_state = port.load_hf_qwen3(path)
    jax_model, jax_vars = jax_load_hf(str(path))
    assert hf_cfg == port.Qwen3Config(**jax_model.config.__dict__)
    want = params_from_jax(jax.tree.map(np.asarray, jax_vars), hf_cfg)
    assert hf_state.keys() == want.keys()
    assert all(torch.equal(hf_state[k], want[k]) for k in want)


@pytest.fixture(scope="module")
def qa_pair():
    from gvl_tpu.training.qa_lm_train import load_qa_lm as jax_load
    from gvl_tpu_torch.training.qa_lm_train import load_qa_lm

    jcfg, jparams = jax_load(QA_CKPT)
    tcfg, state = load_qa_lm(QA_CKPT, device="cpu")
    return jcfg, {"params": jparams}, tcfg, state


def _qa_prompt() -> list[int]:
    """A timestamp question in the served ChatML byte format, 256 tokens or fewer."""
    from gvl_tpu_torch.models.byte_tokenizer import BOS_ID, ByteTokenizer
    from gvl_tpu_torch.training.qa_lm_train import render_chatml

    user = ("## Timeline Context\n[00:12] player detected\n[01:07] boss detected"
            "\n\n## Question\nAt what timestamp is the boss first detected?")
    ids = [BOS_ID] + ByteTokenizer().encode(render_chatml("sys", user))
    assert len(ids) <= 256
    return ids


def test_qa_lm_geometry(qa_pair):
    _, _, tcfg, state = qa_pair
    assert (tcfg.num_layers, tcfg.hidden_size, tcfg.num_heads, tcfg.num_kv_heads,
            tcfg.head_dim, tcfg.intermediate_size, tcfg.vocab_size,
            tcfg.max_cache_length) == (10, 640, 10, 5, 64, 2560, 384, 4608)
    assert tcfg.use_decode_kernel and state["lm_head.weight"].dtype == torch.float32
    assert sum(v.numel() for v in state.values()) > 60_000_000


def test_qa_lm_prefill_logits_match(qa_pair):
    jcfg, jvars, tcfg, state = qa_pair
    ids = np.asarray([_qa_prompt()], np.int32)
    want, _ = JaxModel(jcfg).apply(jvars, jnp.asarray(ids))
    with torch.no_grad():
        got, _ = port.Qwen3Engine(tcfg, state, device="cpu").model(
            torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=QA_LOGITS_ATOL)


def test_qa_lm_greedy_tokens_identical(qa_pair):
    jcfg, jvars, tcfg, state = qa_pair
    ids = _qa_prompt()
    want = JaxEngine(jcfg, jvars, eos_token_id=-1, dtype=jnp.float32).generate(
        ids, max_new_tokens=16, temperature=0.0)
    got = port.Qwen3Engine(tcfg, state, eos_token_id=-1, dtype=torch.float32,
                           device="cpu").generate(ids, max_new_tokens=16,
                                                  temperature=0.0)
    assert got == want and len(got) == 16
