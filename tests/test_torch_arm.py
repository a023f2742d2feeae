"""The ``qa_lm`` arm through gvl_tpu_torch's ``process_video`` and
``answer_query`` against ``scripts/realtime_inference.py``, on the trained
weights of ``outputs/`` (segmenter, OCR, event net, byte ASR, retriever, QA
model), on the CPU.

One short clip with audio, the arm's settings, ``use_cache=False``.
Timeline events and the knowledge base's export must be equal (the
events' confidences, the encoders' f32 scores, within 1e-5), the prompt
ids handed to the QA engine equal, and the answers to two questions equal
with both QA engines in f32 and greedy (the engines' default bf16 cache
can flip a near-tied argmax, and the two packages' samplers draw from
different generators).

This file takes about 110 s alone here (two torch threads): each stack
prefills two prompts of 2.5k-4k bytes into the model's 4096-token bucket.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.model_configs import get_model_config as jax_arm
from benchmarks.model_inference import FullPipelineRunner as JaxRunner
from gvl_tpu.models import qwen3 as jax_qwen3
from gvl_tpu_torch import pipeline as tpipe
from gvl_tpu_torch.eval.model_configs import get_model_config as port_arm
from gvl_tpu_torch.eval.model_inference import FullPipelineRunner
from gvl_tpu_torch.models import qwen3 as port_qwen3
from gvl_tpu_torch.utils.profiler import PromptLog

from scripts import realtime_inference as jri

CONF_TOL = 1e-5     # detection and event confidences (scores in [0, 1], f32)
CLIP = "synthetic://concept_demo_arm?duration=6&fps=2&entities=player,boss&audio=1"
QUESTIONS = ["Does a boss appear at any point in this video? Answer Yes or No.",
             "What does the voice in this clip say? Pick the option matching the spoken "
             "line.\n\nOptions:\nA) enemy ahead take cover\nB) press the button now\n"
             "C) grab the key and run\nD) the bridge is out\n\nAnswer with the letter of "
             "the correct option."]


def _events(timeline):
    return [(e.timestamp, e.modality.value, e.description, e.priority.value, e.duration,
             e.entity_id) for e in timeline.events]


def _f32_default(engine_cls, dtype):
    """``engine_cls``'s ``__init__`` defaults with the cache type ``dtype``."""
    defaults = list(engine_cls.__init__.__defaults__)
    defaults[1] = dtype
    return tuple(defaults)


def _clear_loop_caches():
    jri._LOOP_COMPONENT_CACHE.clear()
    tpipe._LOOP_COMPONENT_CACHE.clear()


@pytest.fixture(scope="module")
def arm():
    """The qa_lm arm's processed clip in both stacks, the QA engines built in
    f32 (their default cache type patched while the loops are built).  The
    loops' components are cached per process; the cache is emptied before
    and after, so that these f32 engines and the tests' changes to them stay
    here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)   # the suite's other workers share the cores
    _clear_loop_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_qwen3.Qwen3Engine.__init__, "__defaults__",
                   _f32_default(jax_qwen3.Qwen3Engine, jnp.float32))
        mp.setattr(port_qwen3.Qwen3Engine.__init__, "__defaults__",
                   _f32_default(port_qwen3.Qwen3Engine, torch.float32))
        jax_runner = JaxRunner(jax_arm("qa_lm"), use_cache=False)
        port_runner = FullPipelineRunner(port_arm("qa_lm"), use_cache=False, device="cpu")
        jax_pv = jri.process_video(CLIP, jax_runner.preset, use_cache=False)
        port_pv = tpipe.process_video(CLIP, port_runner.preset, use_cache=False,
                                      device="cpu")
    yield jax_pv, port_pv
    _clear_loop_caches()
    torch.set_num_threads(threads)


def test_arm_process_video_equal_on_trained_weights(arm):
    jax_pv, port_pv = arm
    assert port_pv.timestamps == jax_pv.timestamps
    assert _events(port_pv.timeline) == _events(jax_pv.timeline)
    np.testing.assert_allclose([e.confidence for e in port_pv.timeline.events],
                               [e.confidence for e in jax_pv.timeline.events],
                               atol=CONF_TOL, rtol=0)
    modalities = {e[1] for e in _events(port_pv.timeline)}
    assert {"visual", "speech", "audio"} <= modalities      # every encoder reported
    assert (port_pv.timeline.build_structured_transcript()
            == jax_pv.timeline.build_structured_transcript())
    assert (port_pv.knowledge_base.export_for_llm(max_entities=15, max_relationships=20)
            == jax_pv.knowledge_base.export_for_llm(max_entities=15, max_relationships=20))
    assert [t for t, _ in port_pv.audio_embeddings] == [t for t, _ in jax_pv.audio_embeddings]
    for (_, a), (_, b) in zip(port_pv.audio_embeddings, jax_pv.audio_embeddings):
        np.testing.assert_array_equal(a, b)
    core = port_pv.loop.reasoning_core
    assert type(core.retriever._embedder).__name__ == "TrainedTextEmbedder"
    assert core.backend.engine.config.hidden_size == 640
    assert core.backend.engine.dtype == torch.float32


def test_arm_answers_equal_in_f32(arm):
    jax_pv, port_pv = arm
    recorders = []
    for pv in (jax_pv, port_pv):
        core = pv.loop.reasoning_core
        core.config.temperature = 0.0
        core.backend.engine = PromptLog(core.backend.engine)
        recorders.append(core.backend.engine)
    want_e, got_e = recorders
    for q in QUESTIONS:
        want = jri.answer_query(jax_pv, q)
        got = tpipe.answer_query(port_pv, q)
        assert got_e.prompts[-1] == want_e.prompts[-1], q
        assert got == want, q
        assert "**Answer:**" in got
    assert (port_pv.loop.reasoning_core.get_conversation_summary()
            == jax_pv.loop.reasoning_core.get_conversation_summary())
