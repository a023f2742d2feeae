"""gvl_tpu_torch.nn's blocks at the JAX blocks' full configuration against
gvl_tpu.nn's, on the CPU.

Every case builds a Flax module at 2 layers, hidden 64, f32, moves every
parameter off its initial value (norm biases and scales included) and
carries the tree across with ``models/convert.py``'s ``stack_from_jax`` /
``block_from_jax``.  Outputs within ``atol`` 1e-5; gradients (input and
every parameter, against ``jax.grad``) within 1e-4.  The JAX quirks the
port keeps are pinned one case each.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.nn import layers as jl
from gvl_tpu_torch import nn as tnn
from gvl_tpu_torch.models.convert import _attention, block_from_jax, stack_from_jax
from gvl_tpu_torch.nn import layers as tl

DIM, HEADS, FFN, LAYERS, SEQ, BATCH = 64, 4, 96, 2, 12, 2
ATOL, GRAD_ATOL = 1e-5, 1e-4

DECODER = dict(norm="rmsnorm", mlp="swiglu", num_kv_heads=2, causal=True, rope=True,
               rope_base=1e6, qk_norm=True, use_bias=False)
STACK_CASES = {
    "encoder": ({}, {}),
    "decoder": (DECODER, {}),
    "decoder-positions": (DECODER, {"positions": np.arange(SEQ) + 7}),
    "gqa-kv_len": (dict(num_kv_heads=1), {"kv_len": 9}),
    "causal-rope-kv_len": (dict(causal=True, rope=True, norm_eps=1e-5), {"kv_len": 5}),
    "head_dim": (dict(head_dim=32, num_kv_heads=2, qk_norm=True), {}),
    "rmsnorm-gelu-nobias-no-final_norm": (dict(norm="rmsnorm", use_bias=False,
                                               final_norm=False), {}),
}


def _moved(tree, seed: int):
    """Every leaf moved by 0.1 N(0, 1) (seeded), so zero biases and unit
    scales carry something."""
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        np.asarray(x, np.float32) + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        for x in leaves])


def _x(seed: int = 0, seq: int = SEQ) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((BATCH, seq, DIM)).astype(np.float32)


def _unprefixed(state: dict) -> dict:
    """A converter's state dict made under the prefix ``"p"``, without it."""
    return {k[2:]: v for k, v in state.items()}


def _port_stack(opts: dict, params) -> torch.nn.Module:
    model = tl.TransformerStack(LAYERS, DIM, HEADS, FFN, **opts)
    model.load_state_dict(_unprefixed(stack_from_jax(params, "p", LAYERS)))
    return model.eval()


def _jax_stack(opts: dict, x: np.ndarray, seed: int = 0):
    module = jl.TransformerStack(num_layers=LAYERS, num_heads=HEADS, intermediate_dim=FFN,
                                 **opts)
    params = _moved(module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"], seed)
    return module, params


def _call_kw(call: dict, torch_side: bool) -> dict:
    kw = dict(call)
    if "positions" in kw:
        kw["positions"] = (torch.from_numpy(kw["positions"]) if torch_side
                           else jnp.asarray(kw["positions"]))
    return kw


@pytest.mark.parametrize("case", list(STACK_CASES))
def test_stack_matches_flax(case):
    opts, call = STACK_CASES[case]
    x = _x()
    module, params = _jax_stack(opts, x)
    kw = _call_kw(call, False)
    static = {k: kw.pop(k) for k in ("kv_len",) if k in kw}
    want = jax.jit(functools.partial(module.apply, **static))(
        {"params": params}, jnp.asarray(x), **kw)
    model = _port_stack(opts, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x), **_call_kw(call, True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["encoder", "decoder"])
def test_stack_gradients_match_jax_grad(case):
    """d(sum(out * w)) for the input and every parameter, carried back to
    the port's names by the same converter."""
    opts, call = STACK_CASES[case]
    x = _x(1)
    weight = np.random.default_rng(2).standard_normal((BATCH, SEQ, DIM)).astype(np.float32)
    module, params = _jax_stack(opts, x, seed=1)

    def loss(p, xx):
        return jnp.sum(module.apply({"params": p}, xx) * weight)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    model = _port_stack(opts, params)
    xt = torch.from_numpy(x).requires_grad_(True)
    (model(xt) * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=GRAD_ATOL)
    want = _unprefixed(stack_from_jax(jax.tree.map(np.asarray, gp), "p", LAYERS))
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), value.numpy(), rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)


def _attention_pair(opts: dict, x: np.ndarray, kv=None):
    module = jl.Attention(num_heads=HEADS, **opts)
    args = (jnp.asarray(x),) if kv is None else (jnp.asarray(x), jnp.asarray(kv))
    params = _moved(module.init(jax.random.PRNGKey(3), *args)["params"], 3)
    port = tl.Attention(DIM, HEADS, **opts)
    port.load_state_dict(_unprefixed(_attention(params, "p")))
    return module, params, port.eval()


@pytest.mark.parametrize("opts", [
    dict(rope=True, qk_norm=True),
    dict(num_kv_heads=2, use_bias=False, rope=True),
    dict(out_dim=48),
], ids=["rope-qk_norm", "gqa-rope", "out_dim"])
def test_cross_attention_matches_flax(opts):
    """``kv`` given: k and v from it, rope on q alone (JAX rotates k only
    when ``kv is None``)."""
    x, kv = _x(4), _x(5, seq=7)
    module, params, port = _attention_pair(opts, x, kv)
    want = module.apply({"params": params}, jnp.asarray(x), jnp.asarray(kv))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(kv))
    assert got.shape == (BATCH, SEQ, opts.get("out_dim", DIM))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    if opts.get("rope"):
        # k is not rotated: positions move q alone, so shifting every q
        # position by the same amount changes the output
        with torch.no_grad():
            shifted = port(torch.from_numpy(x), torch.from_numpy(kv),
                           positions=torch.arange(SEQ) + 3)
        assert not torch.allclose(shifted, got, atol=1e-3)


# ------------------------------------------------------------ JAX's quirks

def test_swiglu_mlp_has_no_bias_whatever_use_bias_says():
    opts = dict(norm="rmsnorm", mlp="swiglu", use_bias=True)
    x = _x(6)
    module = jl.TransformerBlock(num_heads=HEADS, intermediate_dim=FFN, **opts)
    params = _moved(module.init(jax.random.PRNGKey(6), jnp.asarray(x))["params"], 6)
    assert all("bias" not in node for node in params["mlp"].values())
    assert "bias" in params["attention"]["q_proj"]
    port = tl.TransformerBlock(DIM, HEADS, FFN, **opts)
    assert all(m.bias is None for m in (port.mlp.gate_proj, port.mlp.up_proj,
                                        port.mlp.down_proj))
    assert port.attention.q_proj.bias is not None
    port.load_state_dict(_unprefixed(block_from_jax(params, "p")))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    want = module.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_qk_norm_eps_is_1e6_whatever_norm_eps_says():
    """``norm_eps`` 0.5 reaches the block's norms only; with per-head norms
    at 0.5 the output would move far past the tolerance."""
    opts = dict(norm="rmsnorm", qk_norm=True, norm_eps=0.5)
    port = tl.TransformerStack(LAYERS, DIM, HEADS, FFN, **opts)
    block = port.layers[0]
    assert block.ln1.eps == block.ln2.eps == port.final_norm.eps == 0.5
    assert block.attention.q_norm.eps == block.attention.k_norm.eps == 1e-6
    x = _x(7)
    module, params = _jax_stack(opts, x, seed=7)
    model = _port_stack(opts, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = module.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_rope_positions_default_to_arange():
    torch.manual_seed(8)
    model = tl.TransformerStack(LAYERS, DIM, HEADS, FFN, rope=True, causal=True).eval()
    x = _x(8)
    with torch.no_grad():
        default = model(torch.from_numpy(x))
        explicit = model(torch.from_numpy(x), positions=torch.arange(SEQ))
        shifted = model(torch.from_numpy(x), positions=torch.arange(SEQ) + 5)
    assert torch.equal(default, explicit)
    # self-attention rotates q and k alike: a common shift keeps q.k, so
    # only the rounding of the angles moves the output
    torch.testing.assert_close(shifted, default, rtol=0, atol=1e-4)


def test_stack_takes_no_quant_as_jax_passes_none():
    """``TransformerStack`` builds float blocks: JAX's stack has no ``quant``
    field to pass on, and neither has the port's."""
    assert "quant" not in {f.name for f in jl.TransformerStack.__dataclass_fields__.values()}
    assert "quant" not in inspect.signature(tl.TransformerStack).parameters
    model = tl.TransformerStack(1, DIM, HEADS, FFN)
    assert all(type(m) is torch.nn.Linear for m in model.modules()
               if isinstance(m, torch.nn.Linear))
    assert "quant" in inspect.signature(tl.TransformerBlock).parameters


def test_layernorm_carries_scale_and_bias():
    """The ``"layernorm"`` norm is Flax's LayerNorm: a scale and a bias, both
    carried (the moved bias changes the output)."""
    x = _x(9)
    module, params = _jax_stack({}, x, seed=9)
    assert set(params["LayerNorm_0"]) == {"scale", "bias"}
    model = _port_stack({}, params)
    assert set(dict(model.final_norm.named_parameters())) == {"weight", "bias"}
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        model.final_norm.bias.zero_()
        unbiased = model(torch.from_numpy(x))
    want = module.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert not torch.allclose(got, unbiased, atol=1e-3)


def test_package_exports_the_blocks():
    for name in ("RMSNorm", "Attention", "MlpGelu", "MlpSwiGLU", "TransformerBlock",
                 "TransformerStack"):
        assert getattr(tnn, name) is getattr(tl, name)
