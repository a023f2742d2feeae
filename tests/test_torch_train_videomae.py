"""The port's VideoMAE clip-classifier trainer
(``gvl_tpu_torch.training.videomae_train``) held to the JAX package's on
the CPU at a tiny tower (width 32, one layer, 4 frames of 48 px): batches
byte for byte, the first step's loss and gradients from JAX's
``model.init`` weights (bf16-rounded pixels into the f32 tower), three
steps of ``train_clip_encoder``, the checkpoint directory both ways through
the serving classes, the evaluator and ``scripts/train_videomae.py``
against JAX's (from the same ``--init-from`` checkpoint).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.training import videomae_train as jvm
from gvl_tpu_torch.models.convert import clip_classifier_params_from_jax
from gvl_tpu_torch.training import videomae_train as tvm
from gvl_tpu_torch.utils.checkpoints import load_flat_npz

from torch_train_helpers import (
    jit_init,
    assert_grads_close,
    assert_served_close,
    assert_trained_close,
    matching,
    one_torch_thread,  # noqa: F401
    run_scripts,
)

GEOMETRY = dict(hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2,
                image_size=48, num_frames=4)
CFG, JCFG = tvm.mini_videomae_config(**GEOMETRY), jvm.mini_videomae_config(**GEOMETRY)
TRAIN = dict(steps=3, batch_size=2, pool_batches=2, seed=6, log_every=0)


def convert(tree):
    return clip_classifier_params_from_jax(tree, CFG)


@pytest.fixture(scope="module")
def jax_init():
    return jit_init(jvm.build_classifier(JCFG), TRAIN["seed"], jnp.zeros((1, 4, 48, 48, 3)))["params"]


def test_batches_match_jax_byte_for_byte():
    got = tvm.make_batch(np.random.default_rng(2), 3, 48, 4, ("base", "aug"))
    want = jvm.make_batch(np.random.default_rng(2), 3, 48, 4, ("base", "aug"))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def jax_run(jax_init):
    """JAX's trainer with its step jitted once: the first step's batch, loss
    and gradients, and the classifier after three steps."""
    import optax

    cfg = jvm.ClipTrainConfig(model=JCFG, **TRAIN)
    rng = np.random.default_rng(cfg.seed)
    pool = [jvm.make_batch(rng, cfg.batch_size, 48, 4, cfg.styles)
            for _ in range(min(cfg.steps, cfg.pool_batches))]
    model = jvm.build_classifier(JCFG)
    tx = optax.adamw(optax.cosine_decay_schedule(cfg.learning_rate, cfg.steps),
                     weight_decay=cfg.weight_decay)

    @jax.jit
    def step(params, opt_state, clips_u8, dirs, kinds, events):
        def loss_fn(p):
            x = jvm._normalize(clips_u8, jnp).astype(jnp.bfloat16)
            _, d_log, k_log, e_log = model.apply({"params": p}, x)
            ce = optax.softmax_cross_entropy_with_integer_labels
            return (ce(d_log.astype(jnp.float32), dirs).mean()
                    + ce(k_log.astype(jnp.float32), kinds).mean()
                    + ce(e_log.astype(jnp.float32), events).mean())

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    params, opt_state, first = jax_init, tx.init(jax_init), None
    for i in range(cfg.steps):
        params, opt_state, loss, grads = step(params, opt_state, *pool[i % len(pool)])
        first = first or (pool[0], float(loss), grads)
    return first, params


def test_first_step_loss_and_gradients(jax_init, jax_run):
    (batch, jloss, jgrads), _ = jax_run
    from gvl_tpu_torch.training.init_laws import trainable

    with torch.device("meta"):
        model = tvm.ClipClassifier(CFG)
    model = trainable(model, tvm.clip_state(jax_init, CFG, 0), torch.device("cpu"))
    loss = tvm.clip_loss(model, *(torch.from_numpy(a) for a in batch))
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    assert_grads_close(model, convert(jgrads))


@pytest.fixture(scope="module")
def trained(jax_init, jax_run):
    cfg = tvm.ClipTrainConfig(model=CFG, **TRAIN)
    return tvm.train_clip_encoder(cfg, init_params=jax_init, device="cpu"), jax_run[1]


def test_three_steps_match_jax(trained, jax_init):
    got, want = trained
    assert_trained_close(got, convert(want), convert(jax_init), lr=3e-4)


def test_files_load_both_ways(trained, tmp_path):
    got, want = trained
    tvm.save_clip_encoder(got, tmp_path / "port", CFG)
    jvm.save_clip_encoder(want, tmp_path / "jax", JCFG)
    assert ((tmp_path / "port" / "videomae_config.json").read_bytes()
            == (tmp_path / "jax" / "videomae_config.json").read_bytes())
    clips = list(np.random.default_rng(1).integers(0, 256, (2, 4, 40, 48, 3), np.uint8))
    for d in ("port", "jax"):
        tenc = tvm.TrainedClipEncoder.from_dir(tmp_path / d, device="cpu")
        jenc = jvm.TrainedClipEncoder.from_dir(tmp_path / d)
        assert_served_close(tenc.encode_clips(clips), jenc.encode_clips(clips))
        got_cls, want_cls = tenc.classify_clips(clips), jenc.classify_clips(clips)
        for g, w in zip(got_cls, want_cls):
            assert {k: v[0] for k, v in g.items()} == {k: v[0] for k, v in w.items()}
            assert_served_close([v[1] for v in g.values()], [v[1] for v in w.values()])


def test_evaluator_matches_jax(trained):
    got, want = trained
    model = tvm.classifier_from_state(got, CFG, "cpu")
    for shuffle in (False, True):
        assert (tvm.evaluate_clip_encoder(model, n_clips=4, shuffle_frames=shuffle)
                == jvm.evaluate_clip_encoder(want, JCFG, n_clips=4, shuffle_frames=shuffle))


def test_script_matches_jax(tmp_path, caplog, jax_init):
    from gvl_tpu_torch.scripts import train_videomae as tscript

    from scripts import train_videomae as jscript

    jvm.save_clip_encoder(jax_init, tmp_path / "init", JCFG)
    args = ["--steps", "2", "--batch-size", "2", "--eval-clips", "2", "--pool-batches", "2",
            "--seed", "6", "--init-from", str(tmp_path / "init")]
    jlines, tlines = run_scripts(jscript.main, tscript.main, args, tmp_path, caplog,
                                 "--out", "videomae")
    got, want = (convert(load_flat_npz(tmp_path / d / "videomae" / "params.npz"))
                 for d in ("port", "jax"))
    assert_trained_close(got, want, convert(jax_init), lr=3e-4, steps=2)
    metrics = [json.loads((tmp_path / d / "videomae" / "videomae_config.json").read_text())
               for d in ("port", "jax")]
    assert metrics[0] == metrics[1]
    jlines, tlines = matching(jlines, "dir"), matching(tlines, "dir")
    assert len(jlines) == 4 and tlines == jlines
