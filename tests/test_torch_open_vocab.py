"""gvl_tpu_torch's open-vocabulary composite against gvl_tpu's, on the CPU,
on the trained weights (segmenter ``outputs/sam_params.npz``, mini-SigLIP
``outputs/minisiglip``, retriever ``outputs/retriever``).

``OpenVocabSamBackend.from_trained_checkpoints`` on two seeded synthetic
scenes under canonical and unseen prompts: detections (masks equal, the
prompt each lands under equal, scores within 1e-4) as JAX's; the lexicon
resolver's choices equal; the resolver dropped, in both, where no
``retriever/`` lies beside the segmenter checkpoint; the segmenter ladder's
open-vocab rung, its fallback and its HF rung (ROADMAP A10).
"""

import os
import shutil

import numpy as np
import pytest

from gvl_tpu.config import load_preset as jax_preset
from gvl_tpu.perception import batch as jbatch
from gvl_tpu.perception import open_vocab as jov
from gvl_tpu.training.segmenter_train import make_scene as jax_scene
from gvl_tpu.training.siglip_train import UNSEEN_PROMPTS
from gvl_tpu_torch.config import load_preset as port_preset
from gvl_tpu_torch.perception import batch as tbatch
from gvl_tpu_torch.perception import open_vocab as tov
from gvl_tpu_torch.training.segmenter_train import CONCEPTS, make_scene

SEG, MINI = "outputs/sam_params.npz", "outputs/minisiglip"
SCORE_TOL = 1e-4      # cosines of unit f32 embeddings
PROMPTS = ["the protagonist", "a villain", "a giant foe", "a power-up", "castle wall",
           "hero", "enemy", "the final boss", "loot", "a glowing gem"]


@pytest.fixture(scope="module")
def backends():
    return (jov.OpenVocabSamBackend.from_trained_checkpoints(SEG, MINI),
            tov.OpenVocabSamBackend.from_trained_checkpoints(SEG, MINI, device="cpu"))


def _detections(results):
    return [[(det["mask"].mask, det["mask"].confidence,
              tuple(det["mask"].bbox.to_xyxy())) for det in per_concept]
            for per_concept in results]


@pytest.mark.parametrize("seed,prompts", [(4321, list(CONCEPTS)),
                                          (77, [UNSEEN_PROMPTS[c] for c in CONCEPTS])])
def test_detections_equal_jax(backends, seed, prompts):
    jb, tb = backends
    frame, _, _ = make_scene(np.random.default_rng(seed), 256, 2, style="base")
    np.testing.assert_array_equal(frame, jax_scene(np.random.default_rng(seed), 256, 2)[0])
    want = _detections(jb([frame], prompts, [0])[0])
    got = _detections(tb([frame], prompts, [0])[0])
    assert sum(map(len, want)) > 0
    assert [len(c) for c in got] == [len(c) for c in want]
    for g, w in zip(got, want):
        for (gm, gs, gb), (wm, ws, wb) in zip(g, w):
            np.testing.assert_array_equal(gm, wm)
            assert gb == wb and abs(gs - ws) < SCORE_TOL


def test_lexicon_resolver_choices_equal(backends):
    jb, tb = backends
    jr, tr = jb.prompt_resolver, tb.prompt_resolver
    assert jr is not None and tr is not None
    for p in PROMPTS:
        (got, gs), (want, ws) = tr.resolve_scored(p), jr.resolve_scored(p)
        assert got == want, p
        assert abs(gs - ws) < SCORE_TOL, p
    for subset in (PROMPTS[:4], PROMPTS[4:8], PROMPTS):
        assert tr.resolve_set(subset) == jr.resolve_set(subset)


def test_resolver_dropped_without_a_retriever_beside_the_checkpoint(tmp_path):
    seg = tmp_path / "sam_params.npz"
    try:
        os.link(SEG, seg)
    except OSError:
        shutil.copy(SEG, seg)
    assert jov.OpenVocabSamBackend.from_trained_checkpoints(str(seg), MINI).prompt_resolver \
        is None
    assert tov.OpenVocabSamBackend.from_trained_checkpoints(
        str(seg), MINI, device="cpu").prompt_resolver is None


def test_open_vocab_rung_of_the_segmenter_ladder(tmp_path):
    jcfg, tcfg = jax_preset("light"), port_preset("light")
    for cfg in (jcfg, tcfg):
        cfg.perception.sam_backend = "open_vocab"
    got = tbatch.build_segmenter(tcfg, device="cpu")
    want = jbatch.build_segmenter(jcfg)
    assert type(got.backend).__name__ == type(want.backend).__name__ == "OpenVocabSamBackend"
    # neither a trained pair nor HF directories: both fall back to "auto"
    for cfg in (jcfg, tcfg):
        cfg.perception.siglip_checkpoint = None
    assert (type(tbatch.build_segmenter(tcfg, device="cpu").backend).__name__,
            type(jbatch.build_segmenter(jcfg).backend).__name__) == \
        ("TorchSegmenterBackend", "JaxSegmenterBackend")
    # HF SAM + SigLIP directories (ROADMAP A10, ported) are loaded as JAX
    # loads them; these hold nothing, and fail with JAX's error (directories
    # that load: tests/test_torch_hf_encoders.py)
    hf = tmp_path / "hf"
    hf.mkdir()
    for cfg in (jcfg, tcfg):
        cfg.perception.sam_vit_dir = cfg.perception.siglip_checkpoint = str(hf)
    with pytest.raises(OSError) as want:
        jbatch.build_segmenter(jcfg)
    with pytest.raises(OSError) as got:
        tbatch.build_segmenter(tcfg, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(OSError) as got:
        tov.OpenVocabSamBackend.from_checkpoints(str(hf), str(hf), device="cpu")
    assert str(got.value) == str(want.value)


def test_seeded_siglip_clip_and_hico_checkpoints_take_the_trained_layouts(tmp_path, caplog):
    """The mini-SigLIP, clip-classifier and HiCo checkpoints the card writes
    in place of ``outputs/`` hold the trained files' key paths and shapes
    (``checkpoint_layouts.json``) and configs, and every ladder serves them."""
    import json
    import logging
    from pathlib import Path

    from gvl_tpu_torch.perception.encoders import write_random_checkpoints
    from gvl_tpu_torch.temporal.clip_encoder import build_clip_encoder
    from gvl_tpu_torch.temporal.hico import TemporalCompressionModule

    outputs = Path(__file__).resolve().parents[1] / "outputs"
    ckpts = write_random_checkpoints(tmp_path, "cpu", seed=5)
    for written, trained in ((Path(ckpts.minisiglip, "params.npz"),
                              outputs / "minisiglip" / "params.npz"),
                             (Path(ckpts.videomae, "params.npz"),
                              outputs / "videomae" / "params.npz"),
                             (Path(ckpts.hico), outputs / "hico_params.npz")):
        with np.load(written) as a, np.load(trained) as b:
            assert {k: a[k].shape for k in a.files} == {k: b[k].shape for k in b.files}
    for name, keys in (("minisiglip/minisiglip_config.json", ("vision", "text")),
                       ("videomae/videomae_config.json",
                        ("model", "directions", "concepts", "events"))):
        got = json.loads((tmp_path / name).read_text())
        want = json.loads((outputs / name).read_text())
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    cfg = port_preset("light")
    cfg.perception.siglip_checkpoint = ckpts.minisiglip
    cfg.perception.videomae_checkpoint = ckpts.videomae
    assert type(tbatch.build_siglip_encoder(cfg, device="cpu").backend).__name__ == \
        "TorchSigLIPBackend"
    assert type(build_clip_encoder(cfg, device="cpu")).__name__ == "TrainedClipEncoder"
    with caplog.at_level(logging.INFO, logger="gvl_tpu_torch.temporal.hico"):
        module = TemporalCompressionModule(checkpoint=ckpts.hico, device="cpu")
    assert any(r.getMessage() == f"loaded HiCo compressor from {ckpts.hico}"
               for r in caplog.records)
    assert [n for n, _ in module.compressor.named_children()] == ["frame_to_clip"]
