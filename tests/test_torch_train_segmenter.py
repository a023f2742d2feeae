"""The port's segmenter trainer (``gvl_tpu_torch.training.segmenter_train``)
held to the JAX package's on the CPU at a tiny geometry
(``SamConfig.tiny()``): batches byte for byte, the greedy query matching
(two instances competing for one query, slots without an instance), the
first step's loss and gradients from JAX's ``model.init`` weights (within
1e-5), three trainer steps (weights within 1e-5), the flat-npz file both
ways, the evaluator and ``scripts/train_segmenter.py`` against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models import sam as jsam
from gvl_tpu.training import segmenter_train as jseg
from gvl_tpu_torch.models import sam as tsam
from gvl_tpu_torch.models.convert import sam_params_from_jax
from gvl_tpu_torch.training import segmenter_train as tseg

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

CFG = tsam.SamConfig.tiny()
JCFG = jsam.SamConfig.tiny()
# the decoder's self-attention over nearly equal initial queries: its
# softmax is nearly uniform, and its q/k gradients cancel to ~1e-5 of the
# whole gradient
ILL_CONDITIONED = ("decoder.self_0.q_proj", "decoder.self_0.k_proj")
TRAIN = dict(image_size=64, steps=3, batch_size=2, pool_batches=2, log_every=0, seed=3)


@pytest.fixture(scope="module")
def jax_init():
    tokens = jnp.asarray(np.stack([jsam.hash_tokenize(c, JCFG.text_vocab)
                                   for c in jseg.CONCEPTS]))
    return jit_init(jsam.PromptableSegmenter(JCFG), TRAIN["seed"], jnp.zeros((1, 64, 64, 3)), tokens)


def test_batches_match_jax_byte_for_byte():
    got = tseg.make_batch(np.random.default_rng(5), tseg.SegTrainConfig(**TRAIN), CFG)
    want = jseg.make_batch(np.random.default_rng(5), jseg.SegTrainConfig(**TRAIN), JCFG)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _jax_matches(logits, gt, valid):
    """The query JAX's ``segmentation_loss`` matches to each slot."""
    cost = jseg._dice(jax.nn.sigmoid(logits)[:, :, :, None], gt[:, :, None])
    cost = jnp.where(valid[:, :, None, :], cost, jnp.inf)
    taken = jnp.zeros(logits.shape[:3], bool)
    out = []
    for i in range(jseg.MAX_INST):
        qi = jnp.argmin(jnp.where(taken, jnp.inf, cost[..., i]), axis=-1)
        taken = taken | (jax.nn.one_hot(qi, logits.shape[2], dtype=bool) & valid[..., i, None])
        out.append(qi)
    return np.stack([np.asarray(q) for q in out], -1)


def test_greedy_matching_competition_and_empty_slots():
    rng = np.random.default_rng(0)
    gt = (rng.random((1, 2, 3, 8, 8)) < 0.3).astype(np.float32)
    gt[0, 0, 1] = gt[0, 0, 0]                       # two instances want one query
    logits = rng.normal(0, 0.1, (1, 2, 4, 8, 8)).astype(np.float32)
    logits[0, 0, 2] = np.where(gt[0, 0, 0] > 0, 8.0, -8.0)
    valid = np.array([[[True, True, False], [False, False, False]]])
    got = tseg.match_queries(torch.from_numpy(logits), torch.from_numpy(gt),
                             torch.from_numpy(valid)).numpy()
    want = _jax_matches(jnp.asarray(logits), jnp.asarray(gt), jnp.asarray(valid))
    assert np.array_equal(got, want)
    assert got[0, 0, 0] == 2 and got[0, 0, 1] != 2 and (got[0, 1] == 0).all()


@pytest.fixture(scope="module")
def jax_run(jax_init):
    """JAX's trainer step (its loss, ``value_and_grad`` and Optax chain),
    jitted once: the first step's loss, gradients and mask logits, and the
    weights after three steps on the trainer's pool."""
    import optax

    cfg = jseg.SegTrainConfig(**TRAIN)
    rng = np.random.default_rng(cfg.seed)
    pool = [jseg.make_batch(rng, cfg, JCFG) for _ in range(min(cfg.steps, cfg.pool_batches))]
    model = jsam.PromptableSegmenter(JCFG)
    tokens = jnp.asarray(np.stack([jsam.hash_tokenize(c, JCFG.text_vocab)
                                   for c in jseg.CONCEPTS]))
    tx = optax.adamw(optax.cosine_decay_schedule(cfg.learning_rate, cfg.steps),
                     weight_decay=cfg.weight_decay)

    @jax.jit
    def step(params, opt_state, frames, gt, valid):
        def loss_fn(p):
            out = model.apply({"params": p}, frames.astype(jnp.float32) / 255.0, tokens)
            return jseg.segmentation_loss(out, gt.astype(jnp.float32), valid), out

        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads, out

    params = jax_init["params"]
    opt_state = tx.init(params)
    first = None
    for i in range(cfg.steps):
        params, opt_state, loss, grads, out = step(params, opt_state, *pool[i % len(pool)])
        first = first or (float(loss), grads, out["mask_logits"])
    return pool, first, {"params": params}


def test_first_step_loss_gradients_and_matches(jax_init, jax_run):
    pool, (jloss, jgrads, jlogits), _ = jax_run
    frames, gt, valid = pool[0]
    from gvl_tpu_torch.training.init_laws import trainable

    with torch.device("meta"):
        net = tsam.PromptableSegmenter(CFG)
    net = trainable(net, tseg.segmenter_state(jax_init, CFG, 0), torch.device("cpu"))
    tokens = tseg.concept_tokens(CFG, "cpu")
    batch = [torch.from_numpy(a) for a in (frames, gt, valid)]
    loss = tseg.segmenter_loss(net, tokens, *batch)
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    assert_grads_close(net, sam_params_from_jax(jgrads, CFG))
    with torch.no_grad():
        logits = net(batch[0].float() / 255.0, tokens)["mask_logits"]
    got = tseg.match_queries(logits, batch[1].float(), batch[2]).numpy()
    want = _jax_matches(jlogits, jnp.asarray(gt, jnp.float32), jnp.asarray(valid))
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def trained(jax_init, jax_run):
    """Three steps of the port's trainer from JAX's ``model.init`` weights,
    and of JAX's step."""
    got = tseg.train_segmenter(CFG, tseg.SegTrainConfig(**TRAIN), init_params=jax_init,
                               device="cpu")
    return got, jax_run[2]


def test_three_steps_match_jax(trained, jax_init):
    got, want = trained
    assert_trained_close(got, sam_params_from_jax(want, CFG),
                         sam_params_from_jax(jax_init, CFG), lr=3e-4,
                         ill_conditioned=ILL_CONDITIONED)


def test_files_load_both_ways(trained, tmp_path):
    got, want = trained
    tsam.save_segmenter_npz(got, tmp_path / "port.npz", CFG)
    jsam.save_segmenter_npz(want, tmp_path / "jax.npz")
    apply = jax.jit(jsam.PromptableSegmenter(JCFG).apply)
    pixels = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    tokens = np.stack([jsam.hash_tokenize(c, JCFG.text_vocab) for c in ("player", "boss")])
    for path in ("port.npz", "jax.npz"):
        jout = apply(jsam.load_segmenter_npz(tmp_path / path), pixels, tokens)
        with torch.device("meta"):
            net = tsam.PromptableSegmenter(CFG)
        from gvl_tpu_torch.nn.layers import load_module

        net = load_module(net, sam_params_from_jax(tsam.load_segmenter_npz(tmp_path / path),
                                                   CFG), "cpu")
        with torch.no_grad():
            tout = net(torch.from_numpy(pixels), torch.from_numpy(tokens))
        for key in ("mask_logits", "scores"):
            assert_served_close(tout[key], jout[key])
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_evaluator_matches_jax(trained):
    got, want = trained
    kw = dict(n_scenes=2, seed=7, score_threshold=0.0)
    assert (tseg.evaluate_segmenter(got, CFG, device="cpu", **kw)
            == jseg.evaluate_segmenter(want, JCFG, **kw))


def test_script_matches_jax(tmp_path, monkeypatch, caplog, jax_init):
    from gvl_tpu_torch.scripts import train_segmenter as tscript

    from scripts import train_segmenter as jscript

    jit_module_inits(monkeypatch, jsam.PromptableSegmenter)
    monkeypatch.setattr(jscript, "SamConfig", jsam.SamConfig.tiny)
    monkeypatch.setattr(tscript, "SamConfig", tsam.SamConfig.tiny)
    # both runs start from JAX's draw: the packages' random streams differ
    draw = tseg.segmenter_state
    monkeypatch.setattr(tseg, "segmenter_state",
                        lambda p, c, s: draw(jax_init if p is None else p, c, s))
    args = ["--steps", "2", "--batch-size", "2", "--eval-scenes", "2", "--seed", "3"]
    jlines, tlines = run_scripts(jscript.main, tscript.main, args, tmp_path, caplog,
                                 "--out", "sam.npz")
    with np.load(tmp_path / "port" / "sam.npz") as a, np.load(tmp_path / "jax" / "sam.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    got, want = (sam_params_from_jax(tsam.load_segmenter_npz(tmp_path / d / "sam.npz"), CFG)
                 for d in ("port", "jax"))
    assert_trained_close(got, want, sam_params_from_jax(jax_init, CFG), lr=3e-4, steps=2,
                         ill_conditioned=ILL_CONDITIONED)
    jlines, tlines = matching(jlines, "held-out"), matching(tlines, "held-out")
    assert len(jlines) == 2 and tlines == jlines
