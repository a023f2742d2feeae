"""The port's audio-event trainer (``gvl_tpu_torch.audio.event_model``)
held to the JAX package's on the CPU (the net at its own geometry, a
hidden width of 16): batches byte for byte, the first step's loss and
gradients from JAX's ``model.init`` weights, three steps of
``train_event_model``, the npz both ways through the serving classes, the
evaluator and ``scripts/train_audio_events.py`` against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.audio import event_model as jev
from gvl_tpu_torch.audio import event_model as tev
from gvl_tpu_torch.models.convert import event_params_from_jax

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

CFG, JCFG = tev.EventModelConfig(hidden=16), jev.EventModelConfig(hidden=16)
TRAIN = dict(steps=3, batch_size=4, learning_rate=1e-3, seed=2, pool_size=12)


@pytest.fixture(scope="module")
def jax_init():
    return jit_init(jev.AudioEventNet(JCFG), TRAIN["seed"], jnp.zeros((1, JCFG.n_frames, JCFG.n_mels)),
        jnp.zeros((1,)))


def test_batches_match_jax_byte_for_byte():
    got = tev.make_event_batch(np.random.default_rng(4), CFG, 6)
    want = jev.make_event_batch(np.random.default_rng(4), JCFG, 6)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def jax_run(jax_init):
    """JAX's trainer (its pool, gain jitter and ``adam``) with its step
    jitted once: the first step's batch, loss and gradients, and the
    weights after three steps."""
    import optax

    rng = np.random.default_rng(TRAIN["seed"])
    n = TRAIN["pool_size"]
    pool_w = np.stack([jev.synth_event(rng, jev.EVENT_CLASSES[i % 6], JCFG) for i in range(n)])
    pool_y = np.arange(n, dtype=np.int32) % 6
    model = jev.AudioEventNet(JCFG)
    tx = optax.adam(TRAIN["learning_rate"])

    @jax.jit
    def step(params, opt_state, wavs, labels):
        mel, log_rms = jev._features(wavs)

        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(
                model.apply(p, mel, log_rms), labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    params, opt_state, first = jax_init, tx.init(jax_init), None
    for _ in range(TRAIN["steps"]):
        idx = rng.integers(0, n, TRAIN["batch_size"])
        gain = rng.uniform(0.5, 1.5, (TRAIN["batch_size"], 1)).astype(np.float32)
        batch = (pool_w[idx] * gain, pool_y[idx])
        params, opt_state, loss, grads = step(params, opt_state, *batch)
        first = first or (batch, float(loss), grads)
    return first, params


def test_first_step_loss_and_gradients(jax_init, jax_run):
    (batch, jloss, jgrads), _ = jax_run
    from gvl_tpu_torch.training.init_laws import trainable

    with torch.device("meta"):
        net = tev.AudioEventNet(CFG)
    net = trainable(net, tev.event_state(jax_init, CFG, 0), torch.device("cpu"))
    loss = tev.event_loss(net, *(torch.from_numpy(a) for a in batch))
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    assert_grads_close(net, event_params_from_jax(jgrads))


@pytest.fixture(scope="module")
def trained(jax_init, jax_run):
    got = tev.train_event_model(CFG, init_params=jax_init, device="cpu", **TRAIN)
    return got, jax_run[1]


def test_three_steps_match_jax(trained, jax_init):
    got, want = trained
    assert_trained_close(got, event_params_from_jax(want), event_params_from_jax(jax_init),
                         lr=TRAIN["learning_rate"])


def test_files_load_both_ways(trained, tmp_path):
    got, want = trained
    tev.save_event_params(got, tmp_path / "port.npz")
    jev.save_event_params(want, tmp_path / "jax.npz")
    audio = np.random.default_rng(3).normal(0, 0.1, 3 * 16000).astype(np.float32)
    for path in ("port.npz", "jax.npz"):
        jp = jev.load_event_params(tmp_path / path)
        tp = tev.load_event_params(tmp_path / path)
        jdet = jev.JaxAudioEventDetector(jp, JCFG)(audio, 16000)
        tdet = tev.TorchAudioEventDetector(tp, CFG, device="cpu")(audio, 16000)
        assert [c for c, _ in tdet] == [c for c, _ in jdet]
        assert_served_close([p for _, p in tdet], [p for _, p in jdet])
        assert_served_close(tev.TrainedAudioEmbedder(tp, CFG, device="cpu")(audio, 16000),
                            jev.TrainedAudioEmbedder(jp, JCFG)(audio, 16000))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_evaluator_matches_jax(trained):
    got, want = trained
    assert (tev.evaluate_event_model(got, CFG, n_samples=12, seed=5, device="cpu")
            == jev.evaluate_event_model(want, JCFG, n_samples=12, seed=5))


def test_script_matches_jax(tmp_path, monkeypatch, caplog, jax_init):
    from gvl_tpu_torch.scripts import train_audio_events as tscript

    from scripts import train_audio_events as jscript

    jit_module_inits(monkeypatch, jev.AudioEventNet)
    monkeypatch.setattr(jscript, "EventModelConfig", lambda: JCFG)
    monkeypatch.setattr(tscript, "EventModelConfig", lambda: CFG)
    # both runs start from JAX's draw: the packages' random streams differ
    draw = tev.event_state
    monkeypatch.setattr(tev, "event_state", lambda p, c, s: draw(jax_init if p is None else p, c, s))
    args = ["--steps", "2", "--batch-size", "4", "--pool-size", "12", "--eval-samples", "12",
            "--seed", "2"]
    jlines, tlines = run_scripts(jscript.main, tscript.main, args, tmp_path, caplog,
                                 "--out", "events.npz")
    got, want = (event_params_from_jax(tev.load_event_params(tmp_path / d / "events.npz"))
                 for d in ("port", "jax"))
    assert_trained_close(got, want, event_params_from_jax(jax_init), lr=1e-3, steps=2)
    jlines, tlines = matching(jlines, "held-out"), matching(tlines, "held-out")
    assert len(jlines) == 1 and tlines == jlines
