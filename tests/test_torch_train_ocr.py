"""The port's OCR trainers (``gvl_tpu_torch.perception.ocr_model``) held to
the JAX package's on the CPU at tiny nets (a v2 recognizer of widths 8-32
with one attention block over 64 px crops, a detector over 64 x 96
canvases): synthetic text, crops and canvases byte for byte (Pillow
renders them in both), the first step's CTC and BCE losses and gradients
from JAX's ``model.init`` weights, three steps of ``train_recognizer`` and
``train_detector``, the npz both ways through ``TorchOCREngine``, the
evaluator and ``scripts/train_ocr.py`` against JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.perception import ocr_model as jocr
from gvl_tpu_torch.models.convert import ocr_net_params_from_jax
from gvl_tpu_torch.perception import ocr_model as tocr

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

GEOMETRY = dict(rec_arch="v2", rec_width=64, v2_features=(8, 16, 32), v2_heads=2,
                v2_blocks=1, det_height=64, det_width=96, det_features=(4, 8, 8))
CFG, JCFG = tocr.OCRModelConfig(**GEOMETRY), jocr.OCRModelConfig(**GEOMETRY)
REC = dict(steps=3, batch_size=4, seed=3, pool_size=6, use_fonts=True)
DET = dict(steps=3, batch_size=2, seed=4, distractors=True)


@pytest.fixture(scope="module")
def jax_inits():
    rec = jit_init(jocr.make_recognizer(JCFG), REC["seed"], jnp.zeros((1, 32, 64, 1)))
    det = jit_init(jocr.TextDetectorNet(JCFG), DET["seed"], jnp.zeros((1, 64, 96, 1)))
    return {"recognizer": rec, "detector": det}


def test_text_crops_and_canvases_match_jax():
    a, b = np.random.default_rng(1), np.random.default_rng(1)
    assert ([tocr.synth_text(a, CFG.charset) for _ in range(30)]
            == [jocr.synth_text(b, JCFG.charset) for _ in range(30)])
    for fonts in (False, True):
        assert np.array_equal(tocr._synth_crop("HP 12/30", CFG, a, use_fonts=fonts),
                              jocr._synth_crop("HP 12/30", JCFG, b, use_fonts=fonts))
    assert np.array_equal(tocr._synth_negative_crop(CFG, a), jocr._synth_negative_crop(JCFG, b))
    for got, want in zip(tocr.render_frame(["SCORE 10", "LV 3"], CFG, a, distractors=True,
                                           use_fonts=True),
                         jocr.render_frame(["SCORE 10", "LV 3"], JCFG, b, distractors=True,
                                           use_fonts=True)):
        assert np.array_equal(got, want)


def _jax_steps(model, loss_of, params, batches, lr):
    """JAX's step (``value_and_grad`` and ``adam``) jitted once over
    ``batches``: the first step's loss and gradients, and the last
    weights."""
    import optax

    tx = optax.adam(lr)

    @jax.jit
    def step(params, opt_state, *batch):
        loss, grads = jax.value_and_grad(lambda p: loss_of(model.apply(p, batch[0]),
                                                           *batch[1:]))(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    opt_state, first = tx.init(params), None
    for batch in batches:
        params, opt_state, loss, grads = step(params, opt_state, *batch)
        first = first or (float(loss), grads)
    return first, params


@pytest.fixture(scope="module")
def jax_runs(jax_inits):
    """The trainers' batches drawn as JAX's trainers draw them, and JAX's
    steps on them."""
    import optax

    rng = np.random.default_rng(REC["seed"])
    n, b = REC["pool_size"], REC["batch_size"]
    images = np.zeros((n, 32, 64), np.float32)
    labels, pad = np.zeros((n, 16), np.int32), np.ones((n, 16), np.float32)
    for i in range(n):
        if rng.random() < 0.07:
            images[i] = jocr._synth_negative_crop(JCFG, rng)
            continue
        text = jocr.synth_text(rng, JCFG.charset)[:16] or "0"
        images[i] = jocr._synth_crop(text, JCFG, rng, use_fonts=True, photometric=False)
        ids = JCFG.encode(text)
        labels[i, :len(ids)], pad[i, :len(ids)] = ids, 0.0
    rec_batches = []
    for _ in range(REC["steps"]):
        idx = rng.integers(0, n, b)
        raw = images[idx]
        gain, bg = rng.uniform(0.6, 1.0, (b, 1, 1)), rng.uniform(0.0, 0.2, (b, 1, 1))
        raw = np.clip(raw * gain + bg + rng.normal(0, 0.02, raw.shape), 0.0, 1.0)
        rec_batches.append((raw[..., None].astype(np.float32), labels[idx], pad[idx]))

    def ctc(logits, labels, pad):
        return optax.ctc_loss(logits, jnp.zeros(logits.shape[:2], jnp.float32), labels, pad,
                              blank_id=0).mean()

    rng = np.random.default_rng(DET["seed"])
    det_batches = []
    for _ in range(DET["steps"]):
        ims = np.zeros((DET["batch_size"], 64, 96, 1), np.float32)
        tgs = np.zeros((DET["batch_size"], 16, 24), np.float32)
        for k in range(DET["batch_size"]):
            texts = [jocr.synth_text(rng, JCFG.charset) for _ in range(int(rng.integers(1, 4)))]
            ims[k, :, :, 0], tgs[k] = jocr.render_frame(
                texts, JCFG, rng, distractors=bool(rng.random() < 0.8))
        det_batches.append((ims, tgs))

    def bce(logits, targets):
        weight = jnp.where(targets > 0.5, 5.0, 1.0)
        return (optax.sigmoid_binary_cross_entropy(logits, targets) * weight).mean()

    return {"recognizer": (rec_batches, _jax_steps(jocr.make_recognizer(JCFG), ctc,
                                                   jax_inits["recognizer"], rec_batches, 1e-3)),
            "detector": (det_batches, _jax_steps(jocr.TextDetectorNet(JCFG), bce,
                                                 jax_inits["detector"], det_batches, 1e-3))}


@pytest.mark.parametrize("name", ["recognizer", "detector"])
def test_first_step_loss_and_gradients(name, jax_inits, jax_runs):
    batches, ((jloss, jgrads), _) = jax_runs[name]
    net_fn = tocr.make_recognizer if name == "recognizer" else tocr.TextDetectorNet
    loss_fn = tocr.recognizer_loss if name == "recognizer" else tocr.detector_loss
    from gvl_tpu_torch.training.init_laws import trainable

    with torch.device("meta"):
        net = net_fn(CFG)
    net = trainable(net, tocr.ocr_net_state(jax_inits[name], net_fn, CFG, 0),
                    torch.device("cpu"))
    loss = loss_fn(net, *(torch.from_numpy(a) for a in batches[0]))
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    assert_grads_close(net, ocr_net_params_from_jax(jgrads))


@pytest.fixture(scope="module")
def trained(jax_inits, jax_runs):
    rec = tocr.train_recognizer(CFG, params=jax_inits["recognizer"], device="cpu", **REC)
    det = tocr.train_detector(CFG, params=jax_inits["detector"], device="cpu", **DET)
    return ({"recognizer": rec, "detector": det},
            {name: jax_runs[name][1][1] for name in ("recognizer", "detector")})


def test_three_steps_match_jax(trained, jax_inits):
    got, want = trained
    for name in ("recognizer", "detector"):
        assert_trained_close(got[name], ocr_net_params_from_jax(want[name]),
                             ocr_net_params_from_jax(jax_inits[name]), lr=1e-3)


def test_files_load_both_ways_and_evaluator(trained, tmp_path):
    got, want = trained
    tocr.save_ocr_params(got, str(tmp_path / "port.npz"), CFG)
    jocr.save_ocr_params(want, str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    frame = np.zeros((64, 96), np.float32)
    frame[20:40, 10:60] = jocr.render_line("HP 99", 20, 50)
    for path in ("port.npz", "jax.npz"):
        engine = tocr.TorchOCREngine(CFG, checkpoint=str(tmp_path / path), device="cpu")
        jparams = jocr.load_ocr_params(str(tmp_path / path))
        canvas = frame[None, :, :, None]
        assert_served_close(torch.sigmoid(engine.detector(torch.from_numpy(canvas))).detach(),
                            jax.nn.sigmoid(jocr.TextDetectorNet(JCFG).apply(
                                jparams["detector"], canvas)))
    kw = dict(n=8, use_fonts=True)
    assert (tocr.evaluate_recognizer(got["recognizer"], CFG, device="cpu", **kw)
            == jocr.evaluate_recognizer(want["recognizer"], JCFG, **kw))


def test_script_matches_jax(tmp_path, monkeypatch, caplog):
    from gvl_tpu_torch.scripts import train_ocr as tscript

    from scripts import train_ocr as jscript

    jit_module_inits(monkeypatch, jocr.TextRecognizerNetV2, jocr.TextDetectorNet)
    monkeypatch.setattr(jscript, "OCRModelConfig", functools.partial(
        jocr.OCRModelConfig, **{k: v for k, v in GEOMETRY.items() if k != "rec_arch"}))
    monkeypatch.setattr(tscript, "OCRModelConfig", functools.partial(
        tocr.OCRModelConfig, **{k: v for k, v in GEOMETRY.items() if k != "rec_arch"}))
    inits = {"recognizer": jit_init(jocr.make_recognizer(JCFG), 0, jnp.zeros((1, 32, 64, 1))),
             "detector": jit_init(jocr.TextDetectorNet(JCFG), 1, jnp.zeros((1, 64, 96, 1)))}
    # both runs start from JAX's draws: the packages' random streams differ
    draw = tocr.ocr_net_state
    monkeypatch.setattr(tocr, "ocr_net_state", lambda p, net_fn, c, s: draw(
        inits["detector" if net_fn is tocr.TextDetectorNet else "recognizer"]
        if p is None else p, net_fn, c, s))
    args = ["--rec-steps", "2", "--det-steps", "2", "--batch-size", "4", "--pool-size", "6"]
    jlines, tlines = run_scripts(jscript.main, tscript.main, args, tmp_path, caplog,
                                 "--out", "ocr.npz")
    got, want = ({n: ocr_net_params_from_jax(t) for n, t in
                  tocr.load_ocr_params(str(tmp_path / d / "ocr.npz")).items()}
                 for d in ("port", "jax"))
    for name in ("recognizer", "detector"):
        assert_trained_close(got[name], want[name], ocr_net_params_from_jax(inits[name]),
                             lr=1e-3, steps=2)
    jlines, tlines = matching(jlines, "exact match"), matching(tlines, "exact match")
    assert len(jlines) == 2 and tlines == jlines
