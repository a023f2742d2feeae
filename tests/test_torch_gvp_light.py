"""The default ``light`` preset through gvl_tpu_torch's ``process_video`` and
``answer_query`` against ``scripts/realtime_inference.py``, on the trained
weights of ``outputs/`` (mini-SigLIP, OCR, event net, byte ASR, retriever),
on the CPU.

The preset turns the segmenter off and SigLIP on, so the clip takes the
segmenter-free route: zero-shot mini-SigLIP labels of motion proposals,
then whole-frame embeddings.  One short clip with audio, ``use_cache=False``:
timeline events, the transcript and the knowledge base's export must be
equal (confidences within 1e-4), the SigLIP embeddings (MAP-pooled, not
normalised: magnitudes near 20) within 1e-4 of their largest magnitude, the
messages handed to the grounded fake backend equal and its answers equal.
:func:`compare_processed` and :func:`compare_answers` are shared with
``test_torch_gvp_full.py`` and ``test_torch_gvp_videomae.py``.
"""

import numpy as np
import pytest

from gvl_tpu.config import load_preset as jax_preset
from gvl_tpu_torch import pipeline as tpipe
from gvl_tpu_torch.config import load_preset as port_preset
from gvl_tpu_torch.utils.profiler import MessageLog

from scripts import realtime_inference as jri

TOL = 1e-4          # confidences; embeddings: share of their largest magnitude
CLIP = "synthetic://concept_demo_light?duration=8&fps=2&entities=player,boss,enemy&audio=1"
QUESTIONS = ["Does a boss appear at any point in this video? Answer Yes or No.",
             "Besides the player, which of the following entities appears in this video?"
             "\n\nOptions:\nA) enemy\nB) boss\nC) item\nD) None of these\n\nAnswer with the "
             "letter of the correct option."]


def _events(timeline):
    return [(e.timestamp, e.modality.value, e.description, e.priority.value, e.duration,
             e.entity_id) for e in timeline.events]


def compare_processed(jax_pv, port_pv, modalities):
    """Timelines, knowledge bases and embeddings of two processed clips."""
    assert port_pv.timestamps == jax_pv.timestamps
    assert _events(port_pv.timeline) == _events(jax_pv.timeline)
    assert modalities <= {e[1] for e in _events(port_pv.timeline)}
    np.testing.assert_allclose([e.confidence for e in port_pv.timeline.events],
                               [e.confidence for e in jax_pv.timeline.events], atol=TOL, rtol=0)
    assert (port_pv.timeline.build_structured_transcript()
            == jax_pv.timeline.build_structured_transcript())
    assert (port_pv.knowledge_base.export_for_llm(max_entities=15, max_relationships=20)
            == jax_pv.knowledge_base.export_for_llm(max_entities=15, max_relationships=20))
    for name in ("siglip_embeddings", "videomae_embeddings", "audio_embeddings"):
        got, want = getattr(port_pv, name), getattr(jax_pv, name)
        assert [t for t, _ in got] == [t for t, _ in want], name
        if want:
            want = np.stack([e for _, e in want])
            np.testing.assert_allclose(np.stack([e for _, e in got]), want,
                                       atol=TOL * np.abs(want).max(), rtol=0)


def compare_answers(jax_pv, port_pv, questions):
    """The grounded fake's messages and answers to ``questions``."""
    logs = []
    for pv in (jax_pv, port_pv):
        core = pv.loop.reasoning_core
        core.backend = MessageLog(core.backend)
        logs.append(core.backend)
    for q in questions:
        want, got = jri.answer_query(jax_pv, q), tpipe.answer_query(port_pv, q)
        assert logs[1].messages[-1] == logs[0].messages[-1], q
        assert got == want, q
        assert "**Answer:**" in got


@pytest.fixture(scope="module")
def light():
    jri._LOOP_COMPONENT_CACHE.clear()
    tpipe._LOOP_COMPONENT_CACHE.clear()
    jcfg, tcfg = jax_preset("light"), port_preset("light")
    assert (tcfg.perception.use_sam, tcfg.perception.use_siglip,
            tcfg.perception.use_videomae, tcfg.temporal.use_hico) == (False, True, False, False)
    jax_pv = jri.process_video(CLIP, jcfg, use_cache=False)
    port_pv = tpipe.process_video(CLIP, tcfg, use_cache=False, device="cpu")
    yield jax_pv, port_pv
    jri._LOOP_COMPONENT_CACHE.clear()
    tpipe._LOOP_COMPONENT_CACHE.clear()


def test_light_preset_process_video_equal_on_trained_weights(light):
    jax_pv, port_pv = light
    compare_processed(jax_pv, port_pv, {"visual", "speech", "audio"})
    assert "zero_shot_labels" in port_pv.timings and "siglip_embeddings" in port_pv.timings
    assert any(e.entity_id and e.entity_id.startswith("zs_") for e in port_pv.timeline.events)
    assert port_pv.siglip_embeddings[0][1].shape == (384,)
    assert port_pv.loop.config.siglip_dim == 384


def test_light_preset_answers_equal(light):
    compare_answers(*light, QUESTIONS)
