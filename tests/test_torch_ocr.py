"""gvl_tpu_torch's OCR engine and pipeline against gvl_tpu's, on the CPU,
with the shipped checkpoint (``outputs/ocr_params.npz``, a v2 recognizer)
where the row asks for it and JAX-initialised weights elsewhere.

Tolerances: detector probabilities within 1e-5 (no reduction longer than
1152); recognizer logits within 1e-4 (the v2 blocks' 512-wide MLPs and
attention over 96 steps, logits up to ~20); strings, boxes, categories,
component boxes and CTC decodes exactly equal; confidences within 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.perception import ocr as jocr
from gvl_tpu.perception import ocr_model as jom
from gvl_tpu_torch.models.convert import ocr_net_params_from_jax
from gvl_tpu_torch.nn.layers import load_module
from gvl_tpu_torch.perception import ocr as tocr
from gvl_tpu_torch.perception import ocr_model as tom

REPO = Path(__file__).resolve().parents[1]
OCR_CKPT = REPO / "outputs" / "ocr_params.npz"
HUD = (["HP 100/100"], ["LV 12", "SCORE 1250"], ["12:34", "350 gold", "+7"], ["AMMO x30"])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side in one thread: thread pools shared with the suite's
    other workers slow small ops down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engines():
    return (jom.JaxOCREngine(checkpoint=str(OCR_CKPT)),
            tom.TorchOCREngine(checkpoint=str(OCR_CKPT), device="cpu"))


def _frames(config, seed=0, rgb=False):
    rng = np.random.default_rng(seed)
    out = []
    for texts in HUD:
        canvas, _ = jom.render_frame(texts, config, rng, distractors=True)
        frame = (canvas * 255).astype(np.uint8)
        out.append(np.repeat(frame[..., None], 3, -1) if rgb else frame)
    return out


def test_detector_matches_jax(engines):
    jax_eng, port = engines
    x = np.stack([f[..., None].astype(np.float32) / 255 for f in _frames(jax_eng.config)])
    want = np.asarray(jax_eng._det(jax_eng.params["detector"], x))
    np.testing.assert_allclose(port._det(x), want, atol=1e-5, rtol=0)


def test_v2_recognizer_logits_match_jax(engines):
    jax_eng, port = engines
    assert port.config.rec_arch == jax_eng.config.rec_arch == "v2"
    crops = np.random.default_rng(1).uniform(0, 1, (5, 32, 192, 1)).astype(np.float32)
    want = np.asarray(jax_eng._rec(jax_eng.params["recognizer"], crops))
    np.testing.assert_allclose(port._rec(crops), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("net", ["crnn", "detector"])
def test_jax_initialised_nets_match(net):
    """Odd canvas sizes exercise Flax's "SAME" padding (more at the end)."""
    cfg = jom.OCRModelConfig(rec_arch="crnn", det_height=37, det_width=53)
    jnet = jom.TextDetectorNet(cfg) if net == "detector" else jom.TextRecognizerNet(cfg)
    shape = (2, 37, 53, 1) if net == "detector" else (2, 32, 192, 1)
    x = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    tcfg = tom.OCRModelConfig(rec_arch="crnn", det_height=37, det_width=53)
    with torch.device("meta"):
        tnet = tom.TextDetectorNet(tcfg) if net == "detector" else tom.TextRecognizerNet(tcfg)
    tnet = load_module(tnet, ocr_net_params_from_jax(jax.tree.map(np.asarray, params)), "cpu")
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rgb", [False, True])
def test_engine_strings_equal(engines, rgb):
    jax_eng, port = engines
    frames = _frames(jax_eng.config, seed=3, rgb=rgb)
    want, got = jax_eng.batch(frames), port.batch(frames)
    assert [[(t, b) for t, _, b in f] for f in got] == [[(t, b) for t, _, b in f] for f in want]
    for gf, wf in zip(got, want):
        np.testing.assert_allclose([c for _, c, _ in gf], [c for _, c, _ in wf], atol=1e-5)
    assert sum(map(len, want)) >= 5
    assert [(t, b) for t, _, b in port(frames[0])] == [(t, b) for t, _, b in got[0]]


def test_ctc_decoders_and_components_equal():
    cfg = jom.OCRModelConfig()
    rng = np.random.default_rng(4)
    for _ in range(20):
        logits = rng.normal(0, 3, (96, cfg.num_classes)).astype(np.float32)
        for beam in (1, 3, 5):
            assert tom.ctc_beam_decode(logits, cfg, beam) == jom.ctc_beam_decode(logits, cfg, beam)
        assert tom.ctc_decode(logits, cfg) == jom.ctc_decode(logits, cfg)
    mask = rng.random((40, 60)) > 0.7
    assert tom.connected_components(mask) == jom.connected_components(mask)
    crop = rng.uniform(0, 1, (23, 171)).astype(np.float32)
    np.testing.assert_array_equal(tom.crop_to_input(crop, cfg), jom.crop_to_input(crop, cfg))


@pytest.mark.parametrize("backend", ["fake", "trained"])
def test_pipeline_frames_equal(engines, backend):
    jax_eng, port = engines
    frames = _frames(jax_eng.config, seed=5, rgb=True)
    frames.append(frames[1].copy())     # a repeated frame: served from the cache
    rois = [(0.0, 0.0, 0.6, 1.0), (0.4, 0.0, 1.0, 1.0)]
    results = []
    for mod, eng in ((jocr, jax_eng), (tocr, port)):
        config = mod.OCRConfig(roi_regions=rois, min_confidence=0.3)
        pipeline = (mod.OCRPipeline(config, engine=eng) if backend == "trained"
                    else mod.create_ocr_pipeline("fake", config) if mod is jocr
                    else mod.create_ocr_pipeline("fake", config, device="cpu"))
        batch = pipeline.extract_batch(frames, list(range(len(frames))),
                                       [0.5 * i for i in range(len(frames))])
        single = pipeline.extract_text_from_frame(frames[2], 9, 4.5)
        results.append([[(f.frame_idx, f.timestamp, [(d.text, d.bbox, d.category,
                                                       round(d.confidence, 5))
                                                      for d in f.detections])
                         for f in batch + [single]],
                        mod.OCRPipeline.get_text_timeline(batch),
                        mod.OCRPipeline.track_text_changes(batch, "hp")])
    assert results[1] == results[0]
    assert any(f[2] for f in results[0][0])


def test_native_backend_resolves_to_the_shipped_checkpoint(monkeypatch):
    seen = {}
    monkeypatch.setattr(jom, "JaxOCREngine", lambda checkpoint=None: seen.update(jax=checkpoint))
    monkeypatch.setattr(tom, "TorchOCREngine",
                        lambda checkpoint=None, device=None: seen.update(port=checkpoint))
    jocr._resolve_engine(jocr.OCRConfig(backend="native"))
    tocr._resolve_engine(tocr.OCRConfig(backend="native"), device="cpu")
    assert seen["port"] == seen["jax"] == str(OCR_CKPT)
    assert isinstance(tocr._resolve_engine(tocr.OCRConfig(backend="auto")),
                      tocr.DeterministicFakeOCR)


def test_categorizer_and_fake_engine_equal():
    texts = ["1250", "HP 100/100", "LV 12", "12:34", "350 gold", "$5", "hello", " ", "Level up"]
    for t in texts:
        assert tocr.TextCategorizer().categorize(t, ()) == jocr.TextCategorizer().categorize(t, ())
    frame = np.random.default_rng(6).integers(0, 255, (120, 200, 3), dtype=np.uint8)
    assert tocr.DeterministicFakeOCR()(frame) == jocr.DeterministicFakeOCR()(frame)
