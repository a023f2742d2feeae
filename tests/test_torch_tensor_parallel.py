"""Tensor- and data-parallel serving in gvl_tpu_torch against gvl_tpu.

The port's sharded decoder runs in one world of four gloo processes, at
2 x 2 and 1 x 4 meshes (Megatron shards over ``model``, slots over
``data``); JAX's on its 8-device CPU mesh (variables placed by
``shard_pytree``) or unsharded, which JAX's own tests hold equal to its
sharded runs.  Logits are held at 1e-4; greedy tokens must be equal: the
engine (f32, int8, ``scan_layers``), the chat session, speculative and
prompt-lookup decoding and Qwen3-VL's text decoder (the batching engine
at DP x TP: ``tests/test_torch_multichip.py``).
"""

import dataclasses
import os

os.environ.setdefault("USE_TF", "0")   # transformers need not import TensorFlow

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from gvl_tpu.models import qwen3 as jq  # noqa: E402
from gvl_tpu.models.session import Qwen3ChatSession as JaxSession  # noqa: E402
from gvl_tpu.parallel import build_mesh  # noqa: E402
from gvl_tpu.parallel.sharding import LLM_RULES, shard_pytree  # noqa: E402
from gvl_tpu_torch.models import qwen3 as tq  # noqa: E402
from gvl_tpu_torch.models.convert import params_from_jax  # noqa: E402

import torch_mp_cases as cases  # noqa: E402
from torch_world import World  # noqa: E402

LOGITS_TOL = 1e-4
MESHES = [(2, 2), (1, 4)]
PROMPT = [7, 3, 99, 12]
KW = dict(num_heads=8, num_kv_heads=4, head_dim=16, intermediate_size=256,
          vocab_size=512, max_cache_length=64)


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


def _models(seed=0, **kw):
    """(JAX config, JAX params, port config, port state) of one seeded tiny
    decoder."""
    args = {**KW, **kw}
    jcfg, tcfg = jq.Qwen3Config.tiny(**args), tq.Qwen3Config.tiny(**args)
    # jitted: Flax's eager init runs the model op by op
    params = jax.jit(jq.Qwen3Model(jcfg).init)(jax.random.PRNGKey(seed),
                                               jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, tcfg, params_from_jax(jax.tree.map(np.asarray, params), tcfg)


@pytest.fixture(scope="module")
def base():
    return _models()


def _jax_greedy(jcfg, params, prompt=PROMPT, n=6):
    engine = jq.Qwen3Engine(jcfg, {"params": params}, eos_token_id=-1, dtype=jnp.float32)
    return engine.generate(prompt, max_new_tokens=n, temperature=0.0)


@pytest.fixture(scope="module")
def base_greedy(base):
    """JAX's greedy tokens of the base decoder."""
    return _jax_greedy(base[0], base[1])


@pytest.mark.parametrize("variant", ["gqa", "tied", "whole_attention"])
def test_tp_logits_match_jax_sharded_forward(world, variant):
    """Logits against JAX's forward: GQA (4 KV heads cut) at 2 x 2 and
    1 x 4 against JAX's variables sharded over a 2 x 4 mesh; tied
    embeddings (the hidden-cut embedding's product summed over model) at
    2 x 2 and 2 KV heads at 1 x 4 (the attention whole, the MLP cut)
    against JAX's unsharded forward, which JAX's own tests hold to its
    sharded one."""
    kw = {"tied": dict(tie_word_embeddings=True),
          "whole_attention": dict(num_kv_heads=2)}.get(variant, {})
    meshes = {"gqa": MESHES, "tied": [(2, 2)], "whole_attention": [(1, 4)]}[variant]
    jcfg, params, tcfg, state = _models(1, **kw)
    placed = shard_pytree(params, build_mesh(2, 4), LLM_RULES) if variant == "gqa" else params
    tokens = np.array([[5, 9, 2, 44, 17, 3]], np.int32)
    want = np.asarray(jax.jit(lambda p, t: jq.Qwen3Model(jcfg).apply({"params": p}, t)[0])(
        placed, tokens))
    for data, model in meshes:
        for logits in world.run(cases.tp_logits, tcfg, state, data, model, tokens):
            np.testing.assert_allclose(logits, want, atol=LOGITS_TOL, rtol=0)


@pytest.mark.parametrize("variant", ["f32", "int8", "scan"])
def test_tp_greedy_decode_matches_jax(world, base, base_greedy, variant):
    """Greedy tokens equal to JAX's: f32 at both meshes, weight-only int8
    (the JAX dry run's check) at 2 x 2; ``scan_layers`` at head 128 (the
    stacked cache and its decode path) at 2 x 2 equal to the unsharded
    port's, which ``tests/test_torch_serving_ops.py`` holds to JAX."""
    kw = dict(num_heads=4, num_kv_heads=4, head_dim=128, hidden_size=128,
              scan_layers=True) if variant == "scan" else {}
    jcfg, params, tcfg, state = base if variant == "f32" else _models(2, **kw)
    if variant == "int8":
        params = jq.quantize_int8(params, jcfg)
        jcfg = dataclasses.replace(jcfg, quant_int8=True)
        tcfg = dataclasses.replace(tcfg, quant_int8=True)
        state = tq.quantize_int8(state, tq.Qwen3Config.tiny(**KW))
    if variant == "scan":
        want = cases.tp_generate(tcfg, state, 1, 1, PROMPT, 6)
    else:
        want = base_greedy if variant == "f32" else _jax_greedy(jcfg, params)
    for data, model in (MESHES if variant == "f32" else [(2, 2)]):
        assert world.run(cases.tp_generate, tcfg, state, data, model, PROMPT, 6) == [want] * 4


def test_tp_session_and_speculation_match_jax(world, base, base_greedy):
    """The chat session's two turns (the second prefills only its delta),
    speculative decoding with the model as its own draft and prompt lookup:
    JAX's greedy tokens, sharded at 2 x 2."""
    jcfg, params, tcfg, state = base
    want = base_greedy
    session = JaxSession(jcfg, {"params": params}, eos_token_id=-1, dtype=jnp.float32)
    first = session.generate(PROMPT, max_new_tokens=6, temperature=0.0)
    second = session.generate(PROMPT + first + [5, 6], max_new_tokens=6, temperature=0.0)
    got = world.run(cases.tp_generate, tcfg, state, 2, 2, PROMPT, 6, "session")
    assert got == [[first, second, 2]] * 4
    for kind in ("speculative", "lookup"):
        assert world.run(cases.tp_generate, tcfg, state, 2, 2, PROMPT, 6, kind) == [want] * 4


def test_tp_vl_text_decoder_matches_jax(world):
    """Qwen3-VL at JAX's tiny geometry (seeded weights in JAX's layout)
    with its text decoder cut over model at 2 x 2 and the tower whole on
    every rank: a text prompt's greedy tokens equal to JAX's (f32 cache),
    an image prompt's equal to the unsharded port's (which
    ``tests/test_torch_qwen3vl.py`` holds to JAX's; JAX's eager tower takes
    ~11 s to compile here)."""
    from gvl_tpu.models import qwen3vl as jvl
    from gvl_tpu_torch.models import qwen3vl as tvl
    from gvl_tpu_torch.models.convert import qwen3vl_params_from_jax

    from test_qwen3vl import GRID, MROPE_SECTION, make_inputs

    text = dict(hidden_size=48, num_heads=4, num_kv_heads=2, head_dim=16,
                intermediate_size=96, vocab_size=512, max_cache_length=64)
    vision_cfg, text_cfg = jvl.Qwen3VLVisionConfig.tiny(), jq.Qwen3Config.tiny(**text)
    patches, ids = make_inputs()
    tower = jvl.Qwen3VLVisionTower(vision_cfg)
    shapes = {
        "vision": jax.eval_shape(lambda: tower.init(jax.random.PRNGKey(0),
                                                    jnp.asarray(patches), GRID))["params"],
        "text": jax.eval_shape(lambda: jq.Qwen3Model(text_cfg).init(
            jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32)))["params"],
    }
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (np.ones if path[-1].key == "scale" else np.zeros)(
            leaf.shape, np.float32) if path[-1].key in ("scale", "bias")
        else rng.normal(0.0, 0.05, leaf.shape).astype(np.float32), shapes)
    want_vl = jvl.Qwen3VL(vision_cfg, text_cfg, params, image_token_id=7,
                          mrope_section=MROPE_SECTION)
    tv = tvl.Qwen3VLVisionConfig(**dataclasses.asdict(vision_cfg))
    tt = tq.Qwen3Config.tiny(**text)
    state = qwen3vl_params_from_jax(params, tv, tt)
    words = np.array([[11, 12, 13, 14, 15, 16]], np.int64)
    want = want_vl.generate(words, max_new_tokens=6, temperature=0.0, eos_token_id=-1)
    alone = cases.vl_generate(tv, tt, state, 1, 1, ids, patches, GRID, 6, 7, MROPE_SECTION)
    assert world.run(cases.vl_generate, tv, tt, state, 2, 2, words, None, None, 6, 7,
                     MROPE_SECTION) == [want] * 4
    assert world.run(cases.vl_generate, tv, tt, state, 2, 2, ids, patches, GRID, 6, 7,
                     MROPE_SECTION) == [alone] * 4
