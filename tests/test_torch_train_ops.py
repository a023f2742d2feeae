"""The training pieces under the decoder's trainers, held to the JAX
package on the CPU: ``ops.attention.dot_product_attention``'s value and
gradients against ``jax.grad`` of ``gvl_tpu.ops.attention``'s (dense and
blockwise backward, causal and ``kv_len``, grouped heads; f32 within 1e-5,
bf16 within 2e-2), ``training.optim`` against Optax over several updates
of a random tree (within 1e-6), the from-scratch initialiser's per-leaf
standard deviation against ``model.init``'s (within 3 %) and its
truncation bound, ``remat`` (the same gradients as without it), and
``utils.checkpoint.CheckpointManager`` on the cases of
``tests/test_pipeline_checkpoint.py::TestCheckpoint``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gvl_tpu.models import qwen3 as jq
from gvl_tpu.ops import attention as jattn
from gvl_tpu_torch.models import qwen3 as tq
from gvl_tpu_torch.models.convert import params_from_jax, params_to_jax
from gvl_tpu_torch.ops import attention as tattn
from gvl_tpu_torch.training import optim
from gvl_tpu_torch.utils.checkpoint import CheckpointManager

F32_TOL = 1e-5
BF16_TOL = 2e-2
OPTIM_TOL = 1e-6
INIT_STD_SHARE = 0.03


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(rng, hq, hkv, sq, sk, d=16, batch=2):
    return (rng.standard_normal((batch, hq, sq, d), np.float32),
            rng.standard_normal((batch, hkv, sk, d), np.float32),
            rng.standard_normal((batch, hkv, sk, d), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,sq,sk,causal,kv_len", [
    (4, 4, 33, 33, True, None),       # dense, causal
    (4, 2, 40, 48, False, 37),        # dense, key padding, grouped heads
    (2, 1, 1040, 1040, True, None),   # blockwise: 1040^2 > 1024^2 scores
    (2, 2, 1030, 1040, False, 1001),  # blockwise, key padding, short last block
])
def test_attention_value_and_gradients_match_jax(dtype, hq, hkv, sq, sk, causal, kv_len):
    rng = np.random.default_rng(sq + sk + hq)
    q, k, v = _qkv(rng, hq, hkv, sq, sk, batch=1 if sq > 1000 else 2)
    g = rng.standard_normal(q.shape, np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def jloss(q, k, v):
        out = jattn.dot_product_attention(q, k, v, causal=causal, kv_len=kv_len)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))

    tq_, tk, tv = (torch.tensor(a).to(tdt).requires_grad_() for a in (q, k, v))
    out = tattn.dot_product_attention(tq_, tk, tv, causal=causal, kv_len=kv_len)
    (out.float() * torch.from_numpy(g)).sum().backward()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert out.dtype == tdt and tq_.grad.dtype == tdt
    for got, want in [(out, jout), (tq_.grad, jgrads[0]), (tk.grad, jgrads[1]),
                      (tv.grad, jgrads[2])]:
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol, rtol=tol)


def test_attention_kernel_flag_and_inference_take_the_forward_alone():
    """``kernel=False`` and a call without autograd give the plain forward
    (on the CPU both routes are the plain version); under autograd the
    Function's gradients equal autograd's through the plain version."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(a) for a in _qkv(rng, 4, 2, 20, 20))
    want = tattn.attention_reference(q, k, v, causal=True)
    with torch.inference_mode():
        assert torch.equal(tattn.dot_product_attention(q, k, v, causal=True), want)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tattn.dot_product_attention(*leaves, causal=True, kernel=False)
    assert out.grad_fn is not None and torch.equal(out.detach(), want)
    out.square().sum().backward()
    auto = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.attention_reference(*auto, causal=True).square().sum().backward()
    for a, b in zip(leaves, auto):
        torch.testing.assert_close(a.grad, b.grad, atol=F32_TOL, rtol=F32_TOL)


# --------------------------------------------------------------------------
# The optimizer
# --------------------------------------------------------------------------

def _tree(rng):
    return {"a": rng.standard_normal((4, 3), np.float32),
            "b": rng.standard_normal((5,), np.float32),
            "c": rng.standard_normal((2, 2, 3), np.float32)}


def _run_optax(tx, params, grads_seq):
    params = jax.tree.map(jnp.asarray, params)
    state, update = tx.init(params), jax.jit(tx.update)
    for grads in grads_seq:
        updates, state = update(jax.tree.map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


def _run_port(params, grads_seq, frozen=(), **opt):
    """``optim.AdamW(**opt)`` over the leaves not in ``frozen``, each
    gradient of ``grads_seq`` added to the leaves' ``.grad`` as
    ``backward`` adds it."""
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    optimizer = optim.AdamW([p for k, p in params.items() if k not in frozen], **opt)
    for grads in grads_seq:
        for k, p in params.items():
            if k not in frozen:
                g = torch.tensor(grads[k])
                p.grad = g if p.grad is None else p.grad + g
        optimizer.step()
    return {k: v.detach().numpy() for k, v in params.items()}


def _grads(rng, n, scale=1.0):
    return [{k: v * scale for k, v in _tree(rng).items()} for _ in range(n)]


@pytest.mark.parametrize("case", ["warmup_adamw", "clip_small", "cosine_adam_decay",
                                  "constant_lr"])
def test_optimizer_chain_matches_optax(case):
    rng = np.random.default_rng(7)
    params = _tree(rng)
    if case == "warmup_adamw":        # the QA trainer's optimizer
        js = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 2, 6)
        ts = optim.warmup_cosine_decay_schedule(0.0, 3e-3, 2, 6)
        jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(js, weight_decay=0.01))
        opt = dict(learning_rate=ts, weight_decay=0.01, clip=1.0)
        grads = _grads(rng, 6, 3.0)
    elif case == "clip_small":        # the norm stays under the limit
        jtx = optax.chain(optax.clip_by_global_norm(100.0), optax.adamw(1e-2))
        opt = dict(learning_rate=1e-2, clip=100.0)
        grads = _grads(rng, 4, 0.5)
    elif case == "cosine_adam_decay":  # LoraTrainer's inner schedule
        jtx = optax.adamw(optax.cosine_decay_schedule(1e-2, 3), weight_decay=0.1)
        opt = dict(learning_rate=optim.cosine_decay_schedule(1e-2, 3), weight_decay=0.1,
                   clip=math.inf)
        grads = _grads(rng, 5)
    else:
        jtx, opt = optax.adamw(1e-3), dict(learning_rate=1e-3, clip=math.inf)
        grads = _grads(rng, 3)
    want = _run_optax(jtx, params, grads)
    got = _run_port(params, grads, **opt)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], atol=OPTIM_TOL, rtol=OPTIM_TOL)


def test_first_warmup_update_has_learning_rate_zero():
    schedule = optim.warmup_cosine_decay_schedule(0.0, 1e-3, 10, 100)
    jschedule = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 10, 100)
    for count in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert abs(schedule(count) - float(jschedule(count))) <= 1e-9
    rng = np.random.default_rng(1)
    params = _tree(rng)
    got = _run_port(params, _grads(rng, 1), learning_rate=schedule, clip=1.0)
    for k in params:
        assert np.array_equal(got[k], params[k])


def test_multi_transform_freezes_leaves_bit_for_bit():
    """Optax's ``multi_transform`` with ``set_to_zero``: the trainable
    leaves clip over their own norm only; frozen leaves, which the port
    leaves out of its optimizer, keep their bits."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    params["b"][0] = -0.0
    labels = {"a": "lora", "b": "frozen", "c": "lora"}
    jtx = optax.multi_transform(
        {"lora": optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-2)),
         "frozen": optax.set_to_zero()}, labels)
    grads = _grads(rng, 3, 5.0)
    want = _run_optax(jtx, params, grads)
    got = _run_port(params, grads, frozen=("b",), learning_rate=1e-2, clip=1.0)
    assert got["b"].tobytes() == params["b"].tobytes()
    for k in ("a", "c"):
        np.testing.assert_allclose(got[k], want[k], atol=OPTIM_TOL, rtol=OPTIM_TOL)


@pytest.mark.parametrize("every_k", [2, 8])
def test_multisteps_matches_optax(every_k):
    rng = np.random.default_rng(every_k)
    params = _tree(rng)
    labels = {"a": "lora", "b": "frozen", "c": "lora"}
    inner_j = optax.chain(optax.clip_by_global_norm(1.0),
                          optax.adamw(optax.cosine_decay_schedule(1e-2, 1000)))
    jtx = optax.MultiSteps(optax.multi_transform(
        {"lora": inner_j, "frozen": optax.set_to_zero()}, labels), every_k_schedule=every_k)
    opt = dict(frozen=("b",), learning_rate=optim.cosine_decay_schedule(1e-2, 1000), clip=1.0,
               every_k=every_k)
    # at scale 2 every mean is clipped; at 0.2 no mean is, but the sum of
    # the k gradients would be: Adam alone cannot tell a mean from a sum
    for scale in (2.0, 0.2):
        grads = _grads(rng, 2 * every_k + 1, scale)
        want = _run_optax(jtx, params, grads)
        got = _run_port(params, grads, **opt)
        assert got["b"].tobytes() == params["b"].tobytes()
        for k in ("a", "c"):
            np.testing.assert_allclose(got[k], want[k], atol=OPTIM_TOL, rtol=OPTIM_TOL)
            assert not np.array_equal(got[k], params[k])
    # fewer than k gradients make no update
    early = _run_port(params, grads[: every_k - 1], **opt)
    assert all(np.array_equal(early[k], params[k]) for k in params)


# --------------------------------------------------------------------------
# Initialiser, remat, parameter trees
# --------------------------------------------------------------------------

def test_from_scratch_initialiser_follows_the_jax_model():
    # every random leaf holds at least 2**15 values: the two sample stds
    # then agree to ~1 % (one standard error), the limit is 3 %
    geometry = dict(hidden_size=512, intermediate_size=512, num_layers=1, num_heads=4,
                    num_kv_heads=2, head_dim=64, lora_rank=64)
    cfg = tq.Qwen3Config.tiny(**geometry)
    jcfg = jq.Qwen3Config.tiny(**geometry)
    jtree = jq.Qwen3Model(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    want = params_from_jax(jax.tree.map(np.asarray, jtree["params"]), cfg)
    got = tq.init_jax_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert got.keys() == want.keys()
    for name, w in got.items():
        assert w.dtype == torch.float32 and w.shape == want[name].shape, name
        ref = want[name].float()
        if ref.std() == 0:
            assert torch.equal(w, ref), name
            continue
        assert abs(w.std().item() / ref.std().item() - 1) < INIT_STD_SHARE, name
        if name.endswith(("_proj.weight", "lm_head.weight")):
            bound = 2.0 / np.sqrt(w.shape[-1]) / 0.87962566103423978
            assert w.abs().max().item() <= bound * (1 + 1e-6), name
            assert ref.abs().max().item() <= bound * (1 + 1e-6), name


def test_params_to_jax_inverts_params_from_jax():
    for kw in ({}, {"lora_rank": 4}, {"scan_layers": True}):
        cfg = tq.Qwen3Config.tiny(**kw)
        state = tq.init_jax_params(cfg, torch.Generator().manual_seed(1), device="cpu")
        back = params_from_jax(params_to_jax(state, cfg), cfg)
        assert back.keys() == state.keys()
        assert all(torch.equal(back[k], state[k]) for k in state)
    jcfg = jq.Qwen3Config.tiny(lora_rank=4)
    jtree = jax.tree.map(np.asarray, jq.Qwen3Model(jcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])
    cfg = tq.Qwen3Config.tiny(lora_rank=4)
    again = params_to_jax(params_from_jax(jtree, cfg), cfg)
    assert jax.tree.structure(again) == jax.tree.structure(jtree)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(again),
                                                    jax.tree.leaves(jtree)))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_remat_gives_the_same_gradients(scan_layers):
    cfg = tq.Qwen3Config.tiny(scan_layers=scan_layers)
    state = tq.init_jax_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(3))
    grads = []
    for remat in (False, True):
        from dataclasses import replace

        model = tq.load_model(replace(cfg, remat=remat), {k: v.clone() for k, v in state.items()},
                              "cpu")
        logits, _ = model(tokens)
        logits.square().mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# CheckpointManager (the cases of test_pipeline_checkpoint.py::TestCheckpoint)
# --------------------------------------------------------------------------

class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
        state = {"params": {"w": torch.arange(8, dtype=torch.float32)}, "step": 100}
        assert mgr.save(100, state)
        restored = mgr.restore()
        assert torch.equal(restored["params"]["w"], torch.arange(8, dtype=torch.float32))
        assert restored["step"] == 100
        mgr.close()

    def test_retention(self, tmp_path):
        mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
        for step in (1, 2, 3):
            mgr.save(step, {"x": torch.ones(2) * step})
        assert mgr.latest_step() == 3
        assert mgr.all_steps() == [2, 3]   # oldest evicted
        assert torch.equal(mgr.restore(step=2)["x"], torch.full((2,), 2.0))
        mgr.close()

    def test_restore_missing_raises(self, tmp_path):
        mgr = CheckpointManager(tmp_path / "empty")
        with pytest.raises(FileNotFoundError):
            mgr.restore()
        mgr.close()

    def test_optimizer_state_and_template(self, tmp_path):
        """An optimizer's state round-trips: an optimizer loaded from it
        makes the same next update; ``template`` puts the tensors in its
        types."""
        def optimizer(w):
            return optim.AdamW([w], optim.cosine_decay_schedule(1e-2, 10), clip=1.0)

        grads = torch.randn(2, 3, 2)
        w = torch.nn.Parameter(torch.randn(3, 2))
        opt = optimizer(w)
        w.grad = grads[0].clone()
        opt.step()
        mgr = CheckpointManager(tmp_path / "opt", max_to_keep=1)
        assert mgr.save(1, {"params": {"w": w.detach()}, "opt": opt.state_dict()})
        assert not mgr.save(1, {"params": {"w": w.detach()}})      # kept unless forced
        back = mgr.restore(template={"params": {"w": torch.zeros(3, 2, dtype=torch.float64)},
                                     "opt": opt.state_dict()})
        assert back["params"]["w"].dtype == torch.float64
        w2 = torch.nn.Parameter(back["params"]["w"].float())
        opt2 = optimizer(w2)
        opt2.load_state_dict(back["opt"])
        assert opt2.calls == 1
        for p, o in ((w, opt), (w2, opt2)):
            p.grad = grads[1].clone()
            o.step()
        assert torch.equal(w2, w)
