"""The port's HiCo trainer (``gvl_tpu_torch.temporal.hico``) held to the
JAX package's (``gvl_tpu.training.hico_train``) on the CPU at a tiny
width (64, two heads): sequences byte for byte, the first step's loss and
gradients from JAX's ``model.init`` weights (compressor and decoder),
three steps of ``train_hico``, the compressor's npz both ways, the
evaluator and ``scripts/train_hico.py`` against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.temporal import hico as jhico
from gvl_tpu.training import hico_train as jtrain
from gvl_tpu_torch.models.convert import hico_params_from_jax
from gvl_tpu_torch.temporal import hico as thico

from torch_train_helpers import (
    jit_module_inits,
    jit_init,
    assert_grads_close,
    assert_served_close,
    assert_trained_close,
    matching,
    one_torch_thread,  # noqa: F401
    run_scripts,
)

GEOMETRY = dict(hidden_dim=64, num_heads=2, max_positions=32)
CFG, JCFG = thico.HiCoConfig(**GEOMETRY), jhico.HiCoConfig(**GEOMETRY)
TRAIN = dict(steps=3, batch_size=4, frames_per_clip=4, clip_tokens=2, seed=1, log_every=0)


@pytest.fixture(scope="module")
def jax_init():
    wrapper = jtrain._TrainWrapper(JCFG, TRAIN["frames_per_clip"], TRAIN["clip_tokens"])
    return jit_init(wrapper, TRAIN["seed"], jnp.zeros((1, TRAIN["frames_per_clip"], 64)))


def test_sequences_match_jax_byte_for_byte():
    got = thico.make_sequences(np.random.default_rng(3), 4, 5, 16)
    want = jtrain.make_sequences(np.random.default_rng(3), 4, 5, 16)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def jax_run(jax_init):
    """JAX's trainer with its step jitted once: the first step's loss and
    gradients, and the compressor after three steps."""
    import optax

    cfg = jtrain.HicoTrainConfig(**TRAIN)
    rng = np.random.default_rng(cfg.seed)
    pool = [jtrain.make_sequences(rng, cfg.batch_size, cfg.frames_per_clip, 64)
            for _ in range(min(cfg.steps, 64))]
    wrapper = jtrain._TrainWrapper(JCFG, cfg.frames_per_clip, cfg.clip_tokens)
    tx = optax.adamw(optax.cosine_decay_schedule(cfg.learning_rate, cfg.steps))

    @jax.jit
    def step(params, opt_state, seqs):
        def loss_fn(params):
            clip, recon = wrapper.apply({"params": params}, seqs)
            a, b = clip.mean(axis=1), seqs.mean(axis=1)
            a = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
            b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
            nce = optax.softmax_cross_entropy_with_integer_labels(
                (a @ b.T) / cfg.temperature, jnp.arange(a.shape[0])).mean()
            return jnp.mean((recon - seqs) ** 2) + 0.1 * nce

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    params, first = jax_init["params"], None
    opt_state = tx.init(params)
    for i in range(cfg.steps):
        params, opt_state, loss, grads = step(params, opt_state, pool[i % len(pool)])
        first = first or (pool[0], float(loss), grads)
    return first, {"params": params["compressor"]}


def test_first_step_loss_and_gradients(jax_init, jax_run):
    (seqs, jloss, jgrads), _ = jax_run
    from gvl_tpu_torch.training.init_laws import trainable

    cfg = thico.HicoTrainConfig(**TRAIN)
    with torch.device("meta"):
        wrapper = thico.HicoTrainWrapper(CFG, cfg.frames_per_clip, cfg.clip_tokens)
    wrapper = trainable(wrapper, thico.hico_train_state(jax_init, CFG, cfg), torch.device("cpu"))
    loss = thico.hico_loss(wrapper, torch.from_numpy(seqs).float(), cfg.temperature)
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    assert_grads_close(wrapper, thico._wrapper_from_jax(jgrads))


@pytest.fixture(scope="module")
def trained(jax_init, jax_run):
    got = thico.train_hico(CFG, thico.HicoTrainConfig(**TRAIN), init_params=jax_init,
                           device="cpu")
    return got, jax_run[1]


def test_three_steps_match_jax(trained, jax_init):
    got, want = trained
    assert_trained_close(got, hico_params_from_jax(want),
                         hico_params_from_jax(jax_init["params"]["compressor"]), lr=2e-4)


def test_files_load_both_ways(trained, tmp_path):
    got, want = trained
    thico.save_hico_npz(got, tmp_path / "port.npz")
    jhico.save_hico_npz(want, tmp_path / "jax.npz")
    frames = np.random.default_rng(2).normal(size=(3, 6, 64)).astype(np.float32)
    comp = jhico.HierarchicalCompressor(JCFG)
    from gvl_tpu_torch.nn.layers import load_module

    for path in ("port.npz", "jax.npz"):
        jout = comp.apply(jhico.load_hico_npz(tmp_path / path), frames, 2,
                          method=jhico.HierarchicalCompressor.compress_frames_to_clip)
        with torch.device("meta"):
            net = thico.HierarchicalCompressor(CFG, pools=("frame_to_clip",))
        net = load_module(net, hico_params_from_jax(thico.load_hico_npz(tmp_path / path)), "cpu")
        with torch.no_grad():
            assert_served_close(net.compress_frames_to_clip(torch.from_numpy(frames), 2), jout)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_evaluator_matches_jax(trained):
    got, want = trained
    cfg_t, cfg_j = thico.HicoTrainConfig(**TRAIN), jtrain.HicoTrainConfig(**TRAIN)
    assert (thico.evaluate_hico(got, CFG, cfg_t, n_batches=2, device="cpu")
            == jtrain.evaluate_hico(want, JCFG, cfg_j, n_batches=2))


def test_script_matches_jax(tmp_path, monkeypatch, caplog):
    from gvl_tpu_torch.scripts import train_hico as tscript

    from scripts import train_hico as jscript

    jit_module_inits(monkeypatch, jtrain._TrainWrapper)
    monkeypatch.setattr(jscript, "HiCoConfig", lambda: JCFG)
    monkeypatch.setattr(tscript, "HiCoConfig", lambda: CFG)
    init = jit_init(jtrain._TrainWrapper(JCFG, 16, 4), 1, jnp.zeros((1, 16, 64)))
    # both runs start from JAX's draw: the packages' random streams differ
    draw = thico.hico_train_state
    monkeypatch.setattr(thico, "hico_train_state", lambda p, m, c: draw(init if p is None else p, m, c))
    args = ["--steps", "2", "--batch-size", "4", "--seed", "1"]
    jlines, tlines = run_scripts(jscript.main, tscript.main, args, tmp_path, caplog,
                                 "--out", "hico.npz")
    got, want = (hico_params_from_jax(thico.load_hico_npz(tmp_path / d / "hico.npz"))
                 for d in ("port", "jax"))
    assert_trained_close(got, want, hico_params_from_jax(init["params"]["compressor"]),
                         lr=2e-4, steps=2)
    jlines, tlines = matching(jlines, "held-out"), matching(tlines, "held-out")
    assert len(jlines) == 1 and tlines == jlines
