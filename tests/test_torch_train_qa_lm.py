"""``gvl_tpu_torch.training.qa_lm_train``'s trainer against
``gvl_tpu.training.qa_lm_train``'s on the CPU, at the micro geometry of
``tests/test_qa_lm.py`` (hidden 64, 2 layers, 2 heads of 32 over 1 KV
head, batch 8, max_len 640), from JAX's initial parameters.

Tolerances: batches equal byte for byte (fixed pool, and the producer
thread's stream at phase B's mix of pipeline-rendered, lookup and short
samples).  The first step's gradients: in f32 every tensor's within 1e-5
(relative L2) of ``jax.grad``'s; with ``compute_dtype="bfloat16"`` (every
weight cast to bf16 inside the loss) every tensor's distance to JAX's bf16
gradient at most 0.75 x the distance of JAX's own f32 gradient to it (read
on this geometry: at most 0.58; a port that skipped the cast sits at 1.0).
After three steps in f32 every parameter within 1e-5, the displacement from
the initial weights within 1e-4 (relative L2 over all tensors) and the
held-out loss within 1e-5; in bf16 the displacement's distance to JAX's at
most 0.7 x that of JAX's own f32 run (read: 0.49; the f32 path: 1.0) and the
loss within 2e-2.  ``remat`` changes nothing beyond 1e-6.  Checkpoints
written by either package load in the other bit for bit, with the same
config file.  The ``eval_qa_lm_ckpt`` script prints what JAX's prints on a
random micro checkpoint, byte for byte.
"""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gvl_tpu.models.qwen3 import Qwen3Model
from gvl_tpu.training import qa_lm_train as jtrain
from gvl_tpu_torch.models import qwen3 as tq
from gvl_tpu_torch.models.byte_tokenizer import ByteTokenizer
from gvl_tpu_torch.models.convert import params_from_jax
from gvl_tpu_torch.scripts import eval_qa_lm_ckpt as teval
from gvl_tpu_torch.training import qa_lm_train as ttrain

from scripts import eval_qa_lm_ckpt as jeval

F32_TOL, F32_DISP_TOL = 1e-5, 1e-4
BF16_GRAD_RATIO, BF16_DISP_RATIO, BF16_LOSS_TOL = 0.75, 0.7, 2e-2
REMAT_TOL = 1e-6
MICRO = dict(hidden_size=64, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=32,
             intermediate_size=128, max_cache_length=1024)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(**kw):
    common = {**dict(steps=3, batch_size=8, pool_size=16, max_len=640, log_every=0), **kw}
    return (jtrain.QATrainConfig(model=jtrain.qa_lm_config(**MICRO), **common),
            ttrain.QATrainConfig(model=ttrain.qa_lm_config(**MICRO), **common))


@pytest.fixture(scope="module")
def jax_init():
    jcfg, _ = _configs()
    params = Qwen3Model(jcfg.model).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _first_batches(stream, n):
    out = [next(stream) for _ in range(n)]
    stream.close()
    return out


@pytest.mark.parametrize("mode", ["pool", "stream"])
def test_batches_equal_byte_for_byte(mode):
    if mode == "pool":
        jcfg, tcfg = _configs()
        n = 3
    else:   # phase B's mix: pipeline-rendered, lookup and short samples
        jcfg, tcfg = _configs(pool_size=0, pipeline_frac=0.3, short_mix=0.15,
                              lookup_frac=0.1, batch_size=6, max_len=1536, seed=5)
        n = 2
    want = _first_batches(jtrain._batch_stream(jcfg, jtrain.ByteTokenizer()), n)
    got = _first_batches(ttrain._batch_stream(tcfg, ByteTokenizer()), n)
    for (gt, gm), (wt, wm) in zip(got, want):
        assert gt.dtype == wt.dtype and gt.tobytes() == wt.tobytes()
        assert gm.tobytes() == wm.tobytes()


def test_lookup_samples_equal():
    for seed in range(6):
        a = jtrain.generate_lookup_sample(np.random.default_rng(seed), short_system=seed % 2 == 0)
        b = ttrain.generate_lookup_sample(np.random.default_rng(seed), short_system=seed % 2 == 0)
        assert (a.system, a.user_text(), a.answer, a.ground_truth) == \
               (b.system, b.user_text(), b.answer, b.ground_truth)
    assert ttrain.qa_lm_v5_config() == tq.Qwen3Config(
        **{k: v for k, v in jtrain.qa_lm_v5_config().__dict__.items()})


def _held_out(seed=99, n=8, max_len=640):
    rng = np.random.default_rng(seed)
    rows = [ttrain.encode_sample(ttrain.generate_qa_sample(rng), ByteTokenizer(), max_len)
            for _ in range(n)]
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


def _jax_loss(cfg, params, tokens, mask, dtype=jnp.float32):
    """The JAX trainer's ``loss_fn``: every weight cast to ``dtype``."""
    params = jax.tree.map(lambda x: x.astype(dtype), params)
    logits, _ = Qwen3Model(cfg).apply({"params": params}, jnp.asarray(tokens))
    ce = optax.softmax_cross_entropy_with_integer_labels(
        logits[:, :-1].astype(jnp.float32), jnp.asarray(tokens[:, 1:]))
    m = jnp.asarray(mask[:, 1:])
    return (ce * m).sum() / jnp.maximum(m.sum(), 1.0)


def _port_loss(cfg, state, tokens, mask):
    with torch.no_grad():
        model = tq.load_model(cfg, state, "cpu")
        return float(ttrain.qa_loss(model, torch.from_numpy(tokens), torch.from_numpy(mask)))


def _rel_l2(x, ref) -> float:
    return float((x - ref).norm() / ref.norm())


@pytest.fixture(scope="module")
def jax_trained(jax_init):
    """JAX's parameters after three steps, per compute dtype, each run once."""
    runs = {}

    def run(dtype):
        if dtype not in runs:
            jcfg, _ = _configs(compute_dtype=dtype)
            runs[dtype] = jax.tree.map(np.asarray, jtrain.train_qa_lm(jcfg, init_params=jax_init))
        return runs[dtype]

    return run


@pytest.fixture(scope="module")
def first_batch(jax_init):
    """The trainer's first batch and ``jax.grad`` of the JAX trainer's
    ``loss_fn`` on it, in f32 and in bf16 (port layout)."""
    jcfg, tcfg = _configs()
    stream = jtrain._batch_stream(jcfg, jtrain.ByteTokenizer())
    tokens, mask = next(stream)
    stream.close()
    params = jax.tree.map(jnp.asarray, jax_init)
    grads = {}
    for dtype in ("float32", "bfloat16"):
        fn = jax.jit(jax.grad(lambda p, d=dtype: _jax_loss(jcfg.model, p, tokens, mask, d)))
        grads[dtype] = params_from_jax(jax.tree.map(np.asarray, fn(params)), tcfg.model)
    return tokens, mask, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_first_step_gradients_match_jax(jax_init, first_batch, dtype):
    """The loss path's gradients on the trainer's first batch, tensor by
    tensor, against JAX's."""
    tokens, mask, want = first_batch
    _, tcfg = _configs()
    model = ttrain.training_model(tcfg.model, jax_init, "cpu")
    ttrain.qa_loss(model, torch.from_numpy(tokens), torch.from_numpy(mask),
                   getattr(torch, dtype)).backward()
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32
        if dtype == "float32":
            assert _rel_l2(p.grad, want["float32"][name]) <= F32_TOL, name
        else:   # JAX's own f32 gradient, as the yardstick
            w = want["bfloat16"][name]
            assert _rel_l2(p.grad, w) <= BF16_GRAD_RATIO * _rel_l2(want["float32"][name], w), \
                name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_jax(jax_init, jax_trained, dtype):
    jcfg, tcfg = _configs(compute_dtype=dtype)
    want = jax_trained(dtype)
    got = ttrain.train_qa_lm(tcfg, init_params=jax_init, device="cpu")
    want_state = params_from_jax(want, tcfg.model)
    init_state = params_from_jax(jax_init, tcfg.model)

    def displacement(state):
        return torch.cat([(state[n] - init_state[n]).flatten() for n in sorted(init_state)])

    moved = 0
    for name, w in want_state.items():
        assert got[name].dtype == torch.float32
        if dtype == "float32":
            torch.testing.assert_close(got[name], w, atol=F32_TOL, rtol=0, msg=name)
        moved += not torch.equal(got[name], init_state[name])
    assert moved == len(want_state)
    err = _rel_l2(displacement(got), displacement(want_state))
    if dtype == "float32":
        assert err <= F32_DISP_TOL
    else:   # JAX's own f32 run from the same start, as the yardstick
        f32_err = _rel_l2(displacement(params_from_jax(jax_trained("float32"), tcfg.model)),
                          displacement(want_state))
        assert err <= BF16_DISP_RATIO * f32_err
    tokens, mask = _held_out()
    loss_tol = F32_TOL if dtype == "float32" else BF16_LOSS_TOL
    assert abs(_port_loss(tcfg.model, got, tokens, mask)
               - float(_jax_loss(jcfg.model, want, tokens, mask))) <= loss_tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_and_state_dict_warm_start_change_nothing(jax_init, dtype):
    """``remat`` trains the same weights (the bf16 cast is made again where
    a layer is recomputed); a port state dict warm-starts as the JAX tree
    it came from."""
    _, tcfg = _configs(steps=2, compute_dtype=dtype)
    plain = ttrain.train_qa_lm(tcfg, init_params=jax_init, device="cpu")
    remat_cfg = replace(tcfg, model=replace(tcfg.model, remat=True))
    remat = ttrain.train_qa_lm(remat_cfg, init_params=params_from_jax(jax_init, tcfg.model),
                               device="cpu")
    for name, t in plain.items():
        torch.testing.assert_close(remat[name], t, atol=REMAT_TOL, rtol=0, msg=name)


def test_checkpoints_load_in_either_package(jax_init, tmp_path):
    from gvl_tpu.utils.checkpoints import load_flat_npz

    jcfg, tcfg = _configs()
    state = params_from_jax(jax_init, tcfg.model)
    ttrain.save_qa_lm(state, tmp_path / "port", replace(tcfg.model, remat=True))
    jtrain.save_qa_lm(jax_init, tmp_path / "jax", replace(jcfg.model, remat=True))
    assert ((tmp_path / "port" / "qa_lm_config.json").read_bytes()
            == (tmp_path / "jax" / "qa_lm_config.json").read_bytes())
    jax_cfg, jax_params = jtrain.load_qa_lm(tmp_path / "port")
    assert jax_cfg == jcfg.model
    assert jax.tree.structure(jax_params) == jax.tree.structure(jax_init)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(jax_params),
                                                    jax.tree.leaves(jax_init)))
    port_cfg, port_state = ttrain.load_qa_lm(tmp_path / "jax", device="cpu")
    assert port_cfg == tcfg.model
    assert all(torch.equal(port_state[k], state[k]) for k in state)
    saved = load_flat_npz(tmp_path / "port" / "params.npz")
    assert all(np.asarray(a).dtype == np.float32 for a in jax.tree.leaves(saved))
    meta = json.loads((tmp_path / "port" / "qa_lm_config.json").read_text())
    assert "remat" not in meta and "lora_targets" not in meta


def test_training_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs(steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train_qa_lm(tcfg)


def test_eval_qa_lm_ckpt_prints_what_jax_prints(tmp_path, capsys):
    cfg = jtrain.qa_lm_config(hidden_size=64, num_layers=2, num_heads=2, num_kv_heads=1,
                              head_dim=32, intermediate_size=128, max_cache_length=2048)
    params = Qwen3Model(cfg).init(jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))["params"]
    jtrain.save_qa_lm(jax.tree.map(np.asarray, params), tmp_path, cfg)
    args = [str(tmp_path), "--n-samples", "1", "--seeds", "5", "--max-len", "1024",
            "--no-write"]
    assert jeval.main(args) == 0
    want = capsys.readouterr().out
    assert teval.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and "heldout_mean_acc" in want
