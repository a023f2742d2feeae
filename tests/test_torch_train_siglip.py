"""The port's mini-SigLIP trainer and text corpus
(``gvl_tpu_torch.training.siglip_train``, ``training.text_corpus``) held to
the JAX package's on the CPU at tiny towers (width 32, one layer each, 32 px
crops): corpus batches, compositional captions and crop/caption pairs byte
for byte, the first VL step's loss (sigmoid VL loss plus the corpus loss)
and gradients from JAX's ``model.init`` weights and JAX's pretrained text
tower, ``train_minisiglip`` with two steps of ``pretrain_text_tower`` and
three VL steps against JAX's pretraining and steps,
the directory both ways, the evaluator and ``scripts/train_siglip.py``
against JAX's.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models.siglip import SigLIPTextTower as JText
from gvl_tpu.training import siglip_train as jsig
from gvl_tpu.training import text_corpus as jcorpus
from gvl_tpu_torch.training import siglip_train as tsig
from gvl_tpu_torch.training import text_corpus as tcorpus
from gvl_tpu_torch.utils.checkpoints import load_flat_npz

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

VISION = dict(hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2, image_size=32)
TEXT = dict(hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2, projection_size=32)
TRAIN = dict(steps=3, batch_size=8, canvas=32, pool_batches=2, seed=2, log_every=0,
             composed_frac=0.5, text_pretrain_steps=2, text_corpus_weight=0.5,
             text_corpus_batch=8)


def configs(mod):
    return dict(vision=mod.minisiglip_vision_config(**VISION),
                text=mod.minisiglip_text_config(**TEXT))


CFG = tsig.SigLIPTrainConfig(**TRAIN, **configs(tsig))
JCFG = jsig.SigLIPTrainConfig(**TRAIN, **configs(jsig))


def convert(tree):
    return tsig._minisiglip_from_jax(CFG.vision, CFG.text)(tree)


@pytest.fixture(scope="module")
def jax_init():
    model = jsig.MiniSigLIP(JCFG.vision, JCFG.text)
    full = jit_init(model, 2, jnp.zeros((1, 32, 32, 3)),
                      jnp.zeros((1, 32), jnp.int32))
    text = jit_init(JText(JCFG.text), 2 + 7, jnp.zeros((1, 32), jnp.int32))
    return full, text["params"]


def test_corpus_captions_and_pairs_match_jax():
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    assert ([tcorpus.sample_word_context(a) for _ in range(20)]
            == [jcorpus.sample_word_context(b) for _ in range(20)])
    for got, want in zip(tcorpus.word_context_batch(a, 16), jcorpus.word_context_batch(b, 16)):
        assert np.array_equal(got, want)
    assert ([tsig.compose_caption(c, a) for c in tsig.CLASSES * 3]
            == [jsig.compose_caption(c, b) for c in jsig.CLASSES * 3])
    got = tsig.make_pairs(a, 10, 32, composed_frac=0.5)
    want = jsig.make_pairs(b, 10, 32, composed_frac=0.5)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert np.array_equal(got[2], want[2])


@pytest.fixture(scope="module")
def jax_run(jax_init):
    """JAX's ``pretrain_text_tower`` (its own draw jitted), then JAX's VL
    step (its loss with the corpus term, ``value_and_grad`` and Optax
    chain) jitted once over the trainer's pool: the first step's batch,
    start, loss and gradients, and the weights after three steps."""
    import optax

    cfg = JCFG
    with pytest.MonkeyPatch.context() as mp:
        jit_module_inits(mp, JText)
        pretrained = jsig.pretrain_text_tower(cfg)
    start = dict(jax_init[0]["params"], text=pretrained)
    rng = np.random.default_rng(cfg.seed)
    pool = []
    for _ in range(min(cfg.steps, cfg.pool_batches)):
        imgs, caps, cls = jsig.make_pairs(rng, cfg.batch_size, cfg.canvas, styles=cfg.styles,
                                          composed_frac=cfg.composed_frac)
        pool.append((imgs, jsig.byte_tokenize(caps, 32), cls,
                     jcorpus.word_context_batch(rng, cfg.text_corpus_batch, 32)))
    model = jsig.MiniSigLIP(cfg.vision, cfg.text)
    warmup = min(cfg.warmup, max(cfg.steps // 10, 1), cfg.steps - 1)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, cfg.learning_rate, warmup,
                                                        cfg.steps),
                     weight_decay=cfg.weight_decay)

    @jax.jit
    def step(params, opt_state, imgs, ids, cls, corpus):
        def loss_fn(p):
            pixels = imgs.astype(jnp.float32) / 255.0 * 2.0 - 1.0
            _, _, logits = model.apply({"params": p}, pixels, ids)
            zw = model.apply({"params": p}, corpus[0], method=jsig.MiniSigLIP.encode_text)
            zc = model.apply({"params": p}, corpus[1], method=jsig.MiniSigLIP.encode_text)
            lg = zw @ zc.T * jnp.exp(p["logit_scale"]) + p["logit_bias"]
            return (jsig.sigmoid_contrastive_loss(logits, cls)
                    + cfg.text_corpus_weight * jsig.sigmoid_contrastive_loss(lg, corpus[2]))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    params, opt_state, first = start, tx.init(start), None
    for i in range(cfg.steps):
        params, opt_state, loss, grads = step(params, opt_state, *pool[i % len(pool)])
        first = first or (float(loss), grads)
    return pool[0], start, first, params


def test_first_step_loss_and_gradients(jax_run):
    (imgs, ids, cls, corpus), start, (jloss, jgrads), _ = jax_run
    from gvl_tpu_torch.training.init_laws import trainable

    with torch.device("meta"):
        net = tsig.MiniSigLIP(CFG.vision, CFG.text)
    net = trainable(net, tsig.minisiglip_state(start, CFG), torch.device("cpu"))
    t = [torch.from_numpy(a) for a in (imgs, ids, cls)]
    loss = tsig.minisiglip_loss(net, *t, tuple(torch.from_numpy(a) for a in corpus),
                                CFG.text_corpus_weight)
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    assert_grads_close(net, convert(jgrads))


@pytest.fixture(scope="module")
def trained(jax_init, jax_run):
    """The port's ``train_minisiglip`` (its own pretraining, then three VL
    steps) from JAX's draws, and JAX's pretraining and steps."""
    got = tsig.train_minisiglip(CFG, init_params=jax_init[0], text_init_params=jax_init[1],
                                device="cpu")
    return got, {"params": jax_run[3]}


def test_pretraining_and_three_steps_match_jax(trained, jax_init):
    got, want = trained
    init = convert(jax_init[0])
    assert_trained_close(got, convert(want), init, lr=1e-3)


def test_files_load_both_ways_and_evaluator(trained, tmp_path):
    got, want = trained
    tsig.save_minisiglip(got, tmp_path / "port", CFG.vision, CFG.text)
    jsig.save_minisiglip(want, tmp_path / "jax", JCFG.vision, JCFG.text)
    assert ((tmp_path / "port" / "minisiglip_config.json").read_bytes()
            == (tmp_path / "jax" / "minisiglip_config.json").read_bytes())
    kw = dict(n_crops=6, canvas=32)
    for d in ("port", "jax"):
        model, vc, tc = tsig.load_minisiglip(tmp_path / d, device="cpu")
        jmodel, jvars, jvc, jtc = jsig.load_minisiglip(tmp_path / d)
        ids = jsig.byte_tokenize(["the boss", "status bar"], 32)
        assert_served_close(model.encode_text(torch.from_numpy(ids)).detach(),
                            jmodel.apply(jvars, ids, method=jsig.MiniSigLIP.encode_text))
        got_m = tsig.evaluate_minisiglip(model, **kw)
        want_m = jsig.evaluate_minisiglip(jvars, jvc, jtc, **kw)
        margin = got_m.pop("margin"), want_m.pop("margin")
        assert got_m == want_m and abs(margin[0] - margin[1]) <= 1e-5


def test_script_matches_jax(tmp_path, monkeypatch, caplog, jax_init):
    from gvl_tpu_torch.scripts import train_siglip as tscript

    from scripts import train_siglip as jscript

    geometry = dict(canvas=32, **{k: v for k, v in TRAIN.items()
                                  if k in ("pool_batches", "text_corpus_batch")})
    jit_module_inits(monkeypatch, jsig.MiniSigLIP, JText)
    monkeypatch.setattr(jscript, "SigLIPTrainConfig",
                        functools.partial(jsig.SigLIPTrainConfig, **geometry, **configs(jsig)))
    monkeypatch.setattr(tscript, "SigLIPTrainConfig",
                        functools.partial(tsig.SigLIPTrainConfig, **geometry, **configs(tsig)))
    # both runs start from JAX's draws: the packages' random streams differ
    draw, draw_text = tsig.minisiglip_state, tsig.text_tower_state
    monkeypatch.setattr(tsig, "minisiglip_state",
                        lambda p, c: draw(jax_init[0] if p is None else p, c))
    monkeypatch.setattr(tsig, "text_tower_state",
                        lambda p, c, s: draw_text(jax_init[1] if p is None else p, c, s))
    args = ["--steps", "2", "--text-pretrain-steps", "2", "--text-corpus-weight", "0.5",
            "--batch-size", "8", "--eval-crops", "4", "--seed", "2"]
    jlines, tlines = run_scripts(jscript.main, tscript.main, args, tmp_path, caplog,
                                 "--out", "minisiglip")
    got, want = (convert(load_flat_npz(tmp_path / d / "minisiglip" / "params.npz"))
                 for d in ("port", "jax"))
    assert_trained_close(got, want, convert(jax_init[0]), lr=1e-3, steps=2)
    metrics = [json.loads((tmp_path / d / "minisiglip" / "metrics.json").read_text())
               for d in ("port", "jax")]
    for m in metrics:
        for style in m["zero_shot"].values():
            style.pop("margin")
    assert metrics[0] == metrics[1]
    jlines, tlines = matching(jlines, "zero-shot="), matching(tlines, "zero-shot=")
    assert len(jlines) == 3 and tlines == jlines
