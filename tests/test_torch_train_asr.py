"""The port's byte-ASR trainer (``gvl_tpu_torch.training.asr_train``) held
to the JAX package's on the CPU at a tiny Whisper (width 32, one encoder
and one decoder layer, 6 s windows): utterances and rendered batches byte
for byte (inline and through the spawned render pool), the first step's
loss and gradients from JAX's ``model.init`` weights, three steps of
``train_asr`` (clip, AdamW over the warmup cosine schedule), the directory
both ways through ``TrainedByteASR``, the evaluator and
``scripts/train_asr.py`` against JAX's (from the same ``--init-from``
checkpoint; both render inline).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models.whisper import WhisperModel as JWhisper
from gvl_tpu.training import asr_train as jasr
from gvl_tpu_torch.models.convert import whisper_params_from_jax
from gvl_tpu_torch.models.whisper import WhisperModel
from gvl_tpu_torch.training import asr_train as tasr

from torch_train_helpers import (
    jit_init,
    assert_grads_close,
    assert_trained_close,
    matching,
    one_torch_thread,  # noqa: F401
    run_scripts,
)

GEOMETRY = dict(d_model=32, encoder_layers=1, decoder_layers=1, num_heads=2, ffn_dim=64,
                max_target_positions=48)
CFG, JCFG = tasr.asr_config(**GEOMETRY), jasr.asr_config(**GEOMETRY)
TRAIN = dict(steps=3, batch_size=2, seed=5, log_every=0, render_workers=0)


def convert(tree):
    return whisper_params_from_jax(tree, CFG)


@pytest.fixture(scope="module")
def jax_init():
    return jit_init(JWhisper(JCFG), TRAIN["seed"], jnp.zeros((1, 600, 80)),
                               jnp.zeros((1, 4), jnp.int32))["params"]


def test_utterances_match_jax():
    a, b = np.random.default_rng(1), np.random.default_rng(1)
    assert ([tasr.sample_utterance(a) for _ in range(30)]
            == [jasr.sample_utterance(b) for _ in range(30)])
    for text in ("boss at 12 percent", "x" * 60):
        for got, want in zip(tasr.encode_text(text, 48), jasr.encode_text(text, 48)):
            assert np.array_equal(got, want)


def test_batches_match_jax_inline_and_pooled():
    """Inline, one generator seeded ``seed + 1`` draws every batch; the pool
    draws batch ``k`` from a generator seeded ``seed + k`` (JAX's workers
    run ``_render_batch_seeded``)."""
    jcfg = jasr.ASRTrainConfig(model=JCFG, **TRAIN)
    inline_want = jasr._batch_stream(jcfg)
    inline = tasr._batch_stream(tasr.ASRTrainConfig(model=CFG, **TRAIN))
    pooled = tasr._batch_stream(tasr.ASRTrainConfig(model=CFG, **{**TRAIN,
                                                                  "render_workers": 2}))
    for k in range(1, 4):
        pool_want = jasr._render_batch_seeded(jcfg, TRAIN["seed"] + k)
        for got, want in ((next(inline), next(inline_want)), (next(pooled), pool_want)):
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    for stream in (inline_want, inline, pooled):
        stream.close()


@pytest.fixture(scope="module")
def jax_run(jax_init):
    """JAX's trainer with its step jitted once: the first step's batch, loss
    and gradients, and the weights after three steps."""
    import optax

    cfg = jasr.ASRTrainConfig(model=JCFG, **TRAIN)
    model = JWhisper(JCFG)
    warmup = min(cfg.warmup, max(cfg.steps // 10, 1))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, cfg.learning_rate, warmup, cfg.steps),
        weight_decay=cfg.weight_decay))

    @jax.jit
    def step(params, opt_state, mel_f16, tokens, mask):
        mel = mel_f16.astype(jnp.float32)

        def loss_fn(p):
            logits = model.apply({"params": p}, mel, tokens)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1].astype(jnp.float32), tokens[:, 1:])
            tmask = mask[:, 1:]
            return (ce * tmask).sum() / jnp.maximum(tmask.sum(), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    stream = jasr._batch_stream(cfg)
    params, opt_state, first = jax_init, tx.init(jax_init), None
    for _ in range(cfg.steps):
        batch = next(stream)
        params, opt_state, loss, grads = step(params, opt_state, *batch)
        first = first or (batch, float(loss), grads)
    stream.close()
    return first, params


def test_first_step_loss_and_gradients(jax_init, jax_run):
    (batch, jloss, jgrads), _ = jax_run
    from gvl_tpu_torch.training.init_laws import trainable

    with torch.device("meta"):
        model = WhisperModel(CFG)
    model = trainable(model, tasr.asr_state(jax_init, CFG, 0), torch.device("cpu"))
    loss = tasr.asr_loss(model, *(torch.from_numpy(a) for a in batch))
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    assert_grads_close(model, convert(jgrads))


@pytest.fixture(scope="module")
def trained(jax_init, jax_run):
    cfg = tasr.ASRTrainConfig(model=CFG, **TRAIN)
    return tasr.train_asr(cfg, init_params=jax_init, device="cpu"), jax_run[1]


def test_three_steps_match_jax(trained, jax_init):
    got, want = trained
    assert_trained_close(got, convert(want), convert(jax_init), lr=3e-4)


def test_files_load_both_ways_and_evaluator(trained, tmp_path):
    got, want = trained
    tasr.save_asr(got, tmp_path / "port", CFG)
    jasr.save_asr(want, tmp_path / "jax", JCFG)
    assert ((tmp_path / "port" / "asr_config.json").read_bytes()
            == (tmp_path / "jax" / "asr_config.json").read_bytes())
    wav = jasr.synth_speech(np.random.default_rng(3), "boss incoming")
    for d in ("port", "jax"):
        assert (tasr.TrainedByteASR.from_dir(tmp_path / d, device="cpu")(wav, 16000)
                == jasr.TrainedByteASR.from_dir(tmp_path / d)(wav, 16000))
    kw = dict(n_utterances=2, batch_size=2)
    assert (tasr.evaluate_asr(got, CFG, device="cpu", **kw)
            == jasr.evaluate_asr(want, JCFG, **kw))


def test_script_matches_jax(tmp_path, monkeypatch, caplog, jax_init):
    from gvl_tpu_torch.scripts import train_asr as tscript

    from scripts import train_asr as jscript

    # both render inline: the pool gives the same batches (held above)
    monkeypatch.setattr(jscript, "ASRTrainConfig",
                        functools.partial(jasr.ASRTrainConfig, render_workers=0))
    monkeypatch.setattr(tscript, "ASRTrainConfig",
                        functools.partial(tasr.ASRTrainConfig, render_workers=0))
    jasr.save_asr(jax_init, tmp_path / "init", JCFG)
    args = ["--steps", "2", "--batch-size", "2", "--eval-samples", "1", "--seed", "5",
            "--init-from", str(tmp_path / "init")]
    jlines, tlines = run_scripts(jscript.main, tscript.main, args, tmp_path, caplog,
                                 "--out", "asr")
    got, want = (convert(tasr.load_asr(tmp_path / d / "asr")[1]) for d in ("port", "jax"))
    assert_trained_close(got, want, convert(jax_init), lr=3e-4, steps=2)
    metrics = [json.loads((tmp_path / d / "asr" / "asr_config.json").read_text())
               for d in ("port", "jax")]
    assert metrics[0] == metrics[1]
    jlines, tlines = matching(jlines, "exact="), matching(tlines, "exact=")
    assert len(jlines) == 3 and tlines == jlines
