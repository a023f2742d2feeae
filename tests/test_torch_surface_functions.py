"""The functions gvl_tpu_torch gained to match gvl_tpu's public surface,
each against its JAX counterpart on the same inputs, on the CPU.

The tesseract engine runs with a stub ``pytesseract`` in ``sys.modules``
and ``shutil.which`` finding the binary; ``serve`` with ``serve_forever``
patched.  Exact equality wherever both packages compute the same bytes
(detections, resized images, fake-backend embeddings, memory stats);
float tolerances are stated at each comparison.
"""

import functools
import http.server
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.agent.config import ReasoningCoreConfig as JaxCoreConfig
from gvl_tpu.models import projector as jproj
from gvl_tpu.models import sam as jsam
from gvl_tpu.models import whisper as jw
from gvl_tpu.perception import ocr as jocr
from gvl_tpu.perception import semantic as jsem
from gvl_tpu.runtime import native as jnative
from gvl_tpu.serving import api as japi
from gvl_tpu.utils import profiler as jprof
from gvl_tpu_torch.agent.config import ReasoningCoreConfig
from gvl_tpu_torch.models import projector as tproj
from gvl_tpu_torch.models import sam as tsam
from gvl_tpu_torch.models import whisper as tw
from gvl_tpu_torch.models.convert import sam_params_from_jax
from gvl_tpu_torch.nn.layers import load_module
from gvl_tpu_torch.perception import ocr as tocr
from gvl_tpu_torch.perception import semantic as tsem
from gvl_tpu_torch.runtime import native as tnative
from gvl_tpu_torch.serving import api as tapi
from gvl_tpu_torch.utils import profiler as tprof


# ------------------------------------------------------------------ OCR

def _stub_pytesseract() -> types.ModuleType:
    """``image_to_data`` from the image's bytes: three words, one with a
    negative confidence and one blank (both dropped by the engine)."""
    module = types.ModuleType("pytesseract")
    module.Output = types.SimpleNamespace(DICT="dict")

    def image_to_data(image, lang, output_type):
        assert output_type == "dict" and lang == "eng"
        arr = np.asarray(image)
        h, w = arr.shape[:2]
        m = int(arr.mean())
        return {"text": [f"HP {m}", " ", "GAME OVER", f"x{m % 7}"],
                "conf": ["91", "80", "-1", str(40 + m % 50)],
                "left": [1, 2, 3, w // 3], "top": [4, 5, 6, h // 2],
                "width": [30, 10, 40, 12], "height": [9, 9, 9, 9]}

    module.image_to_data = image_to_data
    return module


def _detections(pipeline, frames):
    return [[(d.text, d.confidence, d.bbox, d.category)
             for d in pipeline.extract_text_from_frame(f, i, i / 2.0).detections]
            for i, f in enumerate(frames)]


@pytest.mark.parametrize("backend", ["auto", "tesseract"])
@pytest.mark.parametrize("installed", [True, False])
def test_tesseract_engine_as_jax(monkeypatch, backend, installed):
    which = shutil.which
    monkeypatch.setattr(shutil, "which", lambda name: "/usr/bin/tesseract"
                        if name == "tesseract" and installed else which(name))
    if installed:
        monkeypatch.setitem(sys.modules, "pytesseract", _stub_pytesseract())
    else:
        monkeypatch.delitem(sys.modules, "pytesseract", raising=False)
    rng = np.random.default_rng(22)
    frames = [rng.integers(0, 256, (72, 128, 3), dtype=np.uint8) for _ in range(3)]
    want = jocr.OCRPipeline(jocr.OCRConfig(backend=backend))
    got = tocr.OCRPipeline(tocr.OCRConfig(backend=backend), device="cpu")
    engine = "TesseractOCR" if installed else "DeterministicFakeOCR"
    assert type(want.engine).__name__ == type(got.engine).__name__ == engine
    assert _detections(got, frames) == _detections(want, frames)
    if installed:   # the stub's words, less the blank and the negative confidence
        assert all(per_frame and per_frame[0][0].startswith("HP ")
                   and "GAME OVER" not in {d[0] for d in per_frame}
                   for per_frame in _detections(got, frames))


# --------------------------------------------------------------- semantic

@pytest.mark.parametrize("shape", [(300, 500, 3), (500, 300, 3), (90, 120, 3),
                                   (200, 260)])
def test_resize_with_aspect_ratio_bytes_equal(shape):
    image = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    want, want_aspect = jsem.AspectPreservingResizer(jsem.NaFlexConfig()) \
        .resize_with_aspect_ratio(image)
    got, got_aspect = tsem.AspectPreservingResizer(tsem.NaFlexConfig()) \
        .resize_with_aspect_ratio(image)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got_aspect == want_aspect


def _blob(h, w, cy, cx, r):
    yy, xx = np.mgrid[:h, :w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


@pytest.mark.parametrize("radius", [2, 50])
def test_encode_with_context_matches_jax(radius):
    rng = np.random.default_rng(radius)
    frame = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    mask = _blob(96, 128, 40, 60, 12)
    want = jsem.SigLIPSemanticEncoder().encode_with_context(frame, mask, radius)
    encoder = tsem.create_siglip_encoder()
    assert isinstance(encoder.backend, tsem.DeterministicFakeBackend)
    got = encoder.encode_with_context(frame, mask, radius)
    for g, w in zip(got, want):
        assert (g.entity_id, g.original_bbox, g.aspect_ratio) == \
            (w.entity_id, w.original_bbox, w.aspect_ratio)
        np.testing.assert_array_equal(g.embedding, w.embedding)
    # the same as the two region calls it stands for
    import scipy.ndimage as ndi

    context = ndi.binary_dilation(mask, iterations=max(1, radius // 3)) & ~mask
    again = [encoder.encode_masked_regions(frame, [(name, m)])[0]
             for name, m in (("region", mask), ("context", context))]
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g.embedding, a.embedding)


def test_create_siglip_encoder_fake_backend_as_jax():
    image = np.random.default_rng(5).integers(0, 256, (120, 160, 3), dtype=np.uint8)
    want = jsem.create_siglip_encoder().encode_image(image)
    got = tsem.create_siglip_encoder(device="cpu").encode_image(image)
    np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------------------------------- projector

def test_create_projector_bank_loads_jax_weights(tmp_path):
    dims = dict(siglip_dim=24, internvideo_dim=20, videomae_dim=16, audiomae_dim=12,
                llm_hidden_dim=32)
    path = tmp_path / "projectors.npz"
    fresh = tproj.create_projector_bank(ReasoningCoreConfig(**dims), seed=4, device="cpu")
    fresh.save_weights(path)      # the native layout, which both packages read
    want = jproj.create_projector_bank(JaxCoreConfig(**dims), str(path))
    got = tproj.create_projector_bank(ReasoningCoreConfig(**dims), str(path), device="cpu")
    x = np.random.default_rng(4).standard_normal((5, 24)).astype(np.float32)
    np.testing.assert_allclose(got.project_region(x), np.asarray(want.project_region(x)),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.project_audio(np.ones((2, 12))),
                                  fresh.project_audio(np.ones((2, 12))))


# ------------------------------------------------------- serving, runtime

def test_serve_binds_loopback_and_serves_forever(monkeypatch):
    served = []
    monkeypatch.setattr(http.server.ThreadingHTTPServer, "serve_forever",
                        lambda self, *a, **k: served.append(self))
    japi.serve(port=0)
    tapi.serve(port=0, device="cpu")
    assert len(served) == 2
    for server, service in zip(served, (japi.InferenceService, tapi.InferenceService)):
        assert server.server_address[0] == "127.0.0.1"
        assert isinstance(server.service, service)
        assert server.service.config.preset_name.value == "light"
        server.server_close()


def test_native_available_as_jax():
    assert tnative.native_available() == jnative.native_available()


def test_stage_scope_in_a_profile_and_memory_stats_as_jax():
    with jprof.stage_scope("gvl_stage"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.stage_scope("gvl_stage"):
            torch.ones(4).add_(1)
    assert "gvl_stage" in {e.key for e in prof.key_averages()}
    timer = tprof.StageTimer()
    with timer.stage("decode"):
        pass
    assert list(timer.timings) == ["decode"]
    assert tprof.device_memory_stats() == jprof.device_memory_stats() == {}


# ------------------------------------------------------------ model methods

def test_whisper_model_methods_match_jax():
    cfg = jw.WhisperConfig.tiny_random()
    model = jw.WhisperModel(cfg)
    rng = np.random.default_rng(7)
    mel = rng.normal(0, 1, (2, 40, cfg.num_mel_bins)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(7), jnp.asarray(mel),
                                    jnp.asarray(tokens))
    port = tw.load_whisper(
        tw.WhisperConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}),
        jax.tree.map(np.asarray, variables["params"]), "cpu")

    def apply(method, *args, **kw):
        return jax.jit(functools.partial(model.apply, method=method, **kw))(variables, *args)

    states = apply(jw.WhisperModel.encode, jnp.asarray(mel))
    logits = apply(jw.WhisperModel.decode, jnp.asarray(tokens), states)
    cross = apply(jw.WhisperModel.precompute_cross, states)
    d_head = cfg.d_model // cfg.num_heads
    caches = [(jnp.zeros((2, cfg.num_heads, 8, d_head)),) * 2
              for _ in range(cfg.decoder_layers)]
    step, _ = apply(jw.WhisperModel.decode_step, jnp.asarray(tokens[:, 0]), cross, caches,
                    pos=0)
    with torch.no_grad():
        t_states = port.encode(torch.from_numpy(mel))
        t_logits = port.decode(torch.from_numpy(tokens), t_states)
        t_cross = port.precompute_cross(t_states)
        t_caches = [tuple(torch.zeros(2, cfg.num_heads, 8, d_head) for _ in range(2))
                    for _ in range(cfg.decoder_layers)]
        t_step = port.decode_step(torch.from_numpy(tokens[:, 0]), t_cross, t_caches, 0)
    np.testing.assert_allclose(t_states.numpy(), np.asarray(states), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), rtol=0, atol=1e-4)
    for (tk, tv), (jk, jv) in zip(t_cross, cross):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_step.numpy(), np.asarray(step), rtol=0, atol=1e-4)


def test_segmenter_encode_image_matches_jax():
    cfg = jsam.SamConfig.tiny()
    model = jsam.PromptableSegmenter(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                    jnp.zeros((1, 16), jnp.int32))
    with torch.device("meta"):
        port = tsam.PromptableSegmenter(tsam.SamConfig.tiny())
    port = load_module(port, sam_params_from_jax(jax.tree.map(np.asarray, variables),
                                                 tsam.SamConfig.tiny()), "cpu")
    pixels = np.random.default_rng(8).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(functools.partial(model.apply, method=jsam.PromptableSegmenter.encode_image))(
        variables, jnp.asarray(pixels))
    with torch.no_grad():
        got = port.encode_image(torch.from_numpy(pixels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
