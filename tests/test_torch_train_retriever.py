"""The port's retriever trainer (``gvl_tpu_torch.training.retriever_train``)
held to the JAX package's on the CPU at a tiny text tower (width 32, one
layer): pairs and batches string for string, the first step's loss and
gradients from JAX's ``model.init`` weights, three steps of
``train_retriever``, the checkpoint directory both ways through
``TrainedTextEmbedder``, the evaluator and ``scripts/train_retriever.py``
against JAX's (from the same ``--init-from`` checkpoint: the files and the
logged metrics).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models.siglip import SigLIPTextTower as JTower
from gvl_tpu.training import retriever_train as jret
from gvl_tpu_torch.models.convert import siglip_text_params_from_jax
from gvl_tpu_torch.models.siglip import SigLIPTextTower
from gvl_tpu_torch.training import retriever_train as tret

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
                projection_size=32)
CFG, JCFG = tret.retriever_text_config(**GEOMETRY), jret.retriever_text_config(**GEOMETRY)
TRAIN = dict(steps=3, batch_size=8, seed=4, log_every=0)


def convert(tree):
    return siglip_text_params_from_jax(tree, 1)


@pytest.fixture(scope="module")
def jax_init():
    return jit_init(JTower(JCFG), TRAIN["seed"], jnp.zeros((1, 64), jnp.int32))["params"]


def test_pairs_and_batches_match_jax():
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        assert [tret.make_pair(a) for _ in range(40)] == [jret.make_pair(b) for _ in range(40)]
        assert tret.make_batch(a, 36) == jret.make_batch(b, 36)
        assert tret._eval_timeline(a) == jret._eval_timeline(b)


@pytest.fixture(scope="module")
def jax_run(jax_init):
    """JAX's trainer with its step jitted once: the first step's ids, loss
    and gradients, and the tower after three steps."""
    import optax

    cfg = jret.RetrieverTrainConfig(model=JCFG, **TRAIN)
    model = JTower(JCFG)
    tx = optax.adamw(optax.cosine_decay_schedule(cfg.learning_rate, cfg.steps),
                     weight_decay=cfg.weight_decay)
    inv_t = 1.0 / cfg.temperature

    @jax.jit
    def step(params, opt_state, q_ids, d_ids):
        def loss_fn(p):
            zq = model.apply({"params": p}, q_ids)["pooled"]
            zd = model.apply({"params": p}, d_ids)["pooled"]
            zq = zq / jnp.linalg.norm(zq, axis=-1, keepdims=True)
            zd = zd / jnp.linalg.norm(zd, axis=-1, keepdims=True)
            logits = (zq @ zd.T) * inv_t
            labels = jnp.arange(logits.shape[0])
            ce = optax.softmax_cross_entropy_with_integer_labels
            return 0.5 * (ce(logits, labels).mean() + ce(logits.T, labels).mean())

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    rng = np.random.default_rng(cfg.seed)
    params, opt_state, first = jax_init, tx.init(jax_init), None
    for _ in range(cfg.steps):
        ids = [jret.tokenize(t, 64) for t in jret.make_batch(rng, cfg.batch_size)]
        params, opt_state, loss, grads = step(params, opt_state, *ids)
        first = first or (ids, float(loss), grads)
    return first, params


def test_first_step_loss_and_gradients(jax_init, jax_run):
    (ids, jloss, jgrads), _ = jax_run
    from gvl_tpu_torch.training.init_laws import trainable

    with torch.device("meta"):
        tower = SigLIPTextTower(CFG)
    tower = trainable(tower, tret.retriever_state(jax_init, CFG, 0), torch.device("cpu"))
    loss = tret.retriever_loss(tower, *(torch.from_numpy(a) for a in ids), 0.07)
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    assert_grads_close(tower, convert(jgrads))


@pytest.fixture(scope="module")
def trained(jax_init, jax_run):
    cfg = tret.RetrieverTrainConfig(model=CFG, **TRAIN)
    return tret.train_retriever(cfg, init_params=jax_init, device="cpu"), jax_run[1]


def test_three_steps_match_jax(trained, jax_init):
    got, want = trained
    assert_trained_close(got, convert(want), convert(jax_init), lr=3e-4)


def test_files_load_both_ways(trained, tmp_path):
    got, want = trained
    tret.save_retriever(got, tmp_path / "port", CFG)
    jret.save_retriever(want, tmp_path / "jax", JCFG)
    assert ((tmp_path / "port" / "retriever_config.json").read_bytes()
            == (tmp_path / "jax" / "retriever_config.json").read_bytes())
    texts = ["the boss appears", "HP 120/300", "who said save your ammo"]
    for d in ("port", "jax"):
        assert_served_close(tret.TrainedTextEmbedder.from_dir(tmp_path / d, device="cpu")
                            .encode(texts),
                            jret.TrainedTextEmbedder.from_dir(tmp_path / d).encode(texts))
    with np.load(tmp_path / "port" / "params.npz") as a, \
            np.load(tmp_path / "jax" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_evaluator_matches_jax(trained):
    got, want = trained
    assert (tret.evaluate_retriever(tret.TrainedTextEmbedder(CFG, got, device="cpu"),
                                    n_timelines=6)
            == jret.evaluate_retriever(jret.TrainedTextEmbedder(JCFG, want), n_timelines=6))


def test_script_matches_jax(tmp_path, monkeypatch, caplog, jax_init):
    from gvl_tpu_torch.scripts import train_retriever as tscript

    from scripts import train_retriever as jscript

    jret.save_retriever(jax_init, tmp_path / "init", JCFG)
    args = ["--steps", "2", "--batch-size", "8", "--eval-timelines", "4", "--seed", "4",
            "--init-from", str(tmp_path / "init")]
    jlines, tlines = run_scripts(jscript.main, tscript.main, args, tmp_path, caplog,
                                 "--out", "retriever")
    got, want = (convert(tret.load_retriever(tmp_path / d / "retriever")[1])
                 for d in ("port", "jax"))
    assert_trained_close(got, want, convert(jax_init), lr=3e-4, steps=2)
    metrics = [json.loads((tmp_path / d / "retriever" / "retriever_config.json").read_text())
               for d in ("port", "jax")]
    assert metrics[0] == metrics[1]
    jlines, tlines = matching(jlines, "top1="), matching(tlines, "top1=")
    assert len(jlines) == 3 and tlines == jlines
