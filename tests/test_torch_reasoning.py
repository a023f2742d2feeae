"""gvl_tpu_torch's reasoning core, perception loop, projectors and
pipeline-rendered QA samples against gvl_tpu's, on the CPU.

Exact equality for everything rendered (chat messages, loop queries,
responses of the deterministic backends, samples); the projector heads in
f32 within 1e-5 on the same parameters (one 2-layer MLP, sums of at most
1152 terms).  Retrieval runs on the hashing embedder here (exact in both
packages); the trained embedder is held to JAX in
``tests/test_torch_retriever.py`` and on the arm in
``tests/test_torch_pipeline.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gvl_tpu.agent import core as jcore
from gvl_tpu.agent import loop as jloop
from gvl_tpu.agent.config import ReasoningCoreConfig as JaxConfig
from gvl_tpu.fusion import knowledge_base as jkb
from gvl_tpu.fusion import timeline as jtl
from gvl_tpu.models import projector as jproj
from gvl_tpu.training import qa_lm_train as jqa
from gvl_tpu_torch.agent import core as tcore
from gvl_tpu_torch.agent import loop as tloop
from gvl_tpu_torch.agent.config import ReasoningCoreConfig
from gvl_tpu_torch.fusion import knowledge_base as tkb
from gvl_tpu_torch.fusion import timeline as ttl
from gvl_tpu_torch.models import projector as tproj
from gvl_tpu_torch.models.convert import projector_params_from_jax
from gvl_tpu_torch.training import qa_lm_train as tqa

PROJ_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(pkg_tl, pkg_kb):
    """A clip's memory in one package: detections, speech, audio, OCR, and
    tracked entities with relationships."""
    rng = np.random.default_rng(5)
    timeline, kb = pkg_tl.TimelineIndexer(), pkg_kb.KnowledgeBaseBuilder()
    M = pkg_tl.ModalityType
    for t, label in ((0.0, "player"), (0.0, "boss"), (12.0, "enemy"), (47.0, "item")):
        timeline.add_event(t, M.VISUAL, f"{label} detected", entity_id=f"{label}_000",
                           confidence=0.9)
    timeline.add_event(0.4, M.SPEECH, "a0t0n19 enemy ahead take cove", confidence=0.7)
    for t, ev in ((3.0, "impact sound"), (31.0, "UI chime"), (65.0, "background music")):
        timeline.add_event(t, M.AUDIO, ev, confidence=0.8)
    timeline.add_event(20.0, M.OCR, "HP 40", confidence=0.9)
    timeline.merge_and_dedupe()
    for label in ("player", "boss", "enemy"):
        for k in range(2):
            x, y = rng.uniform(30, 280), rng.uniform(30, 200)
            kb.register_entity(f"{label}_{k:03d}", label, timestamp=0.0)
            kb.update_entity_state(f"{label}_{k:03d}", 10.0, position=(x, y),
                                   bbox=(x - 9, y - 9, x + 9, y + 9))
    kb.infer_relationships_at(10.0)
    return timeline, kb


class _Recording:
    """Wraps a backend; keeps each call's messages and embedding prefix."""

    def __init__(self, backend):
        self.backend, self.calls = backend, []

    def stream(self, messages, config, inputs_embeds_prefix=None):
        self.calls.append((messages, None if inputs_embeds_prefix is None
                           else np.shape(inputs_embeds_prefix)))
        yield from self.backend.stream(messages, config)


QUERIES = [
    "Does a boss appear at any point in this video? Answer Yes or No.",
    "What happened after that?",                    # follow-up: anchors to history
    "What does the voice in this clip say?\n\nOptions:\nA) enemy ahead take cover\n"
    "B) press the button now\n\nAnswer with the letter of the correct option.",
    "What does the sound at [00:31] imply about the gameplay?",   # timestamped
    "and then?",
]


@pytest.mark.parametrize("fake", ["TimelineGroundedFakeBackend", "TemplateFakeBackend"])
def test_reasoning_core_renders_and_answers_as_jax(fake):
    jt, jk = _scene(jtl, jkb)
    tt, tk = _scene(ttl, tkb)
    want_b = _Recording(getattr(jcore, fake)())
    got_b = _Recording(getattr(tcore, fake)())
    want_core = jcore.ReasoningCore(JaxConfig(embedding_model="hashing"), backend=want_b)
    got_core = tcore.ReasoningCore(ReasoningCoreConfig(embedding_model="hashing"),
                                   backend=got_b, device="cpu")
    for q in QUERIES:
        want_msgs, want_ts = want_core._prepare(q, jt, jk, None, None, True, None)
        got_msgs, got_ts = got_core._prepare(q, tt, tk, None, None, True, None)
        assert got_msgs == want_msgs and got_ts == want_ts, q
        want = want_core.reason(q, timeline_indexer=jt, knowledge_base=jk,
                                return_confidence=True)
        got = got_core.reason(q, timeline_indexer=tt, knowledge_base=tk,
                              return_confidence=True)
        assert got == want, q
    assert [c[0] for c in got_b.calls] == [c[0] for c in want_b.calls]
    assert got_core.get_conversation_summary() == want_core.get_conversation_summary()
    streamed = list(got_core.reason_streaming("any enemies?", timeline_indexer=tt,
                                              knowledge_base=tk))
    assert streamed == list(want_core.reason_streaming("any enemies?", timeline_indexer=jt,
                                                       knowledge_base=jk))
    assert got_core.get_ttft_stats()["count"] == want_core.get_ttft_stats()["count"]


def test_conversation_save_load_and_tool_loop(tmp_path):
    """Saved conversations load in the other package; a tool call in the
    first pass runs the second pass with the same prompt (no searcher:
    the tool reports itself unavailable in both)."""

    class _ToolFake:
        def __init__(self):
            self.n = 0

        def stream(self, messages, config, inputs_embeds_prefix=None):
            self.n += 1
            text = ('<tool_call>search_web("boss weakness")</tool_call>\nchecking'
                    if self.n == 1 else "**Answer:** use fire")
            yield from text.split(" ")

    jt, jk = _scene(jtl, jkb)
    tt, tk = _scene(ttl, tkb)
    want_b, got_b = _Recording(_ToolFake()), _Recording(_ToolFake())
    want_core = jcore.ReasoningCore(JaxConfig(embedding_model="hashing"), backend=want_b)
    got_core = tcore.ReasoningCore(ReasoningCoreConfig(embedding_model="hashing"),
                                   backend=got_b, device="cpu")
    want = want_core.reason("how do I beat the boss?", timeline_indexer=jt, knowledge_base=jk)
    got = got_core.reason("how do I beat the boss?", timeline_indexer=tt, knowledge_base=tk)
    assert got == want and len(got_b.calls) == 2
    assert [c[0] for c in got_b.calls] == [c[0] for c in want_b.calls]
    want_core.save_conversation(str(tmp_path / "jax.json"))
    got_core.save_conversation(str(tmp_path / "port.json"))
    got_core.load_conversation(str(tmp_path / "jax.json"))
    want_core.load_conversation(str(tmp_path / "port.json"))
    assert (got_core.build_prompt("and then?", "ctx")
            == want_core.build_prompt("and then?", "ctx"))


def test_create_reasoning_core_branches(tmp_path):
    """Each branch of the factory as JAX's takes it: the grounded fake
    without a checkpoint (the speculative knobs alone change nothing), the
    Qwen3-VL backend and the HF text backend (with its session engine) on
    saved tiny HF directories, answering as JAX's at temperature 0, and a
    directory that holds no weights raising JAX's error (more in
    ``tests/test_torch_qwen3vl.py`` and ``tests/test_torch_hf_qwen3.py``)."""
    from test_torch_hf_qwen3 import save_tiny_qwen3, save_tiny_qwen3vl

    core = tcore.create_reasoning_core(ReasoningCoreConfig(embedding_model="hashing"),
                                       device="cpu")
    assert isinstance(core.backend, tcore.TimelineGroundedFakeBackend)
    core = tcore.create_reasoning_core(ReasoningCoreConfig(embedding_model="hashing"),
                                       draft_checkpoint_path=str(tmp_path),
                                       use_prompt_lookup=True, device="cpu")
    assert isinstance(core.backend, tcore.TimelineGroundedFakeBackend)
    empty = tmp_path / "empty"
    empty.mkdir()
    for kw in ({"vl_checkpoint_path": str(empty)}, {"checkpoint_path": str(empty)}):
        with pytest.raises(OSError) as want:
            jcore.create_reasoning_core(JaxConfig(embedding_model="hashing"), **kw)
        with pytest.raises(OSError) as got:
            tcore.create_reasoning_core(ReasoningCoreConfig(embedding_model="hashing"),
                                        device="cpu", **kw)
        assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
    common = dict(embedding_model="hashing", temperature=0.0, max_new_tokens=4,
                  system_prompt="Answer from the timeline.")
    frame = np.random.default_rng(0).integers(0, 256, (48, 80, 3), dtype=np.uint8)
    for kw, backend_type in (
            ({"vl_checkpoint_path": str(save_tiny_qwen3vl(tmp_path / "vl"))},
             tcore.Qwen3VLChatBackend),
            ({"checkpoint_path": str(save_tiny_qwen3(tmp_path / "text"))},
             tcore.Qwen3ChatBackend)):
        want_core = jcore.create_reasoning_core(JaxConfig(**common), **kw)
        got_core = tcore.create_reasoning_core(ReasoningCoreConfig(**common), device="cpu",
                                               **kw)
        assert type(got_core.backend) is backend_type
        assert getattr(got_core.backend, "session", True) is not None
        ask = dict(current_frame=frame, track_conversation=False)
        assert got_core.reason("what is on screen?", **ask) == want_core.reason(
            "what is on screen?", **ask)


def _small_config(pkg_config, **kw):
    return pkg_config(embedding_model="hashing", siglip_dim=24, videomae_dim=20,
                      internvideo_dim=28, audiomae_dim=16, llm_hidden_dim=32, **kw)


@pytest.fixture(scope="module")
def banks():
    jcfg, tcfg = _small_config(JaxConfig), _small_config(ReasoningCoreConfig)
    jax_bank = jproj.ProjectorBank(jcfg).init(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, jax_bank.params)
    port_bank = tproj.ProjectorBank(tcfg, device="cpu").init()
    port_bank.load_params(projector_params_from_jax(params))
    return jax_bank, port_bank


def test_projector_bank_matches_jax(banks, tmp_path):
    jax_bank, port_bank = banks
    rng = np.random.default_rng(0)
    for name, dim in (("siglip", 24), ("videomae", 20), ("video", 28), ("audio", 16)):
        for shape in ((5, dim), (dim,), (17, dim)):
            x = rng.standard_normal(shape).astype(np.float32)
            want = np.asarray(jax_bank.project(name, x))
            got = port_bank.project(name, x)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=PROJ_TOL, rtol=PROJ_TOL)
    # the npz layout both ways, the .pt layout (f16 on disk) from the port to JAX
    x = rng.standard_normal((3, 16)).astype(np.float32)
    jax_bank.save_weights(tmp_path / "bank.npz")
    fresh = tproj.ProjectorBank(port_bank.config, device="cpu").init(seed=9)
    fresh.load_weights(tmp_path / "bank.npz")
    np.testing.assert_allclose(fresh.project_audio(x), np.asarray(jax_bank.project_audio(x)),
                               atol=PROJ_TOL, rtol=PROJ_TOL)
    port_bank.save_weights(tmp_path / "bank.pt")
    other = jproj.ProjectorBank(jax_bank.config).init(jax.random.PRNGKey(7))
    other.load_weights(tmp_path / "bank.pt")
    back = tproj.ProjectorBank(port_bank.config, device="cpu").init(seed=9)
    back.load_weights(tmp_path / "bank.pt")
    np.testing.assert_allclose(back.project_audio(x), np.asarray(other.project_audio(x)),
                               atol=PROJ_TOL, rtol=PROJ_TOL)


def test_projector_head_of_another_width_is_kept_fresh(tmp_path):
    """A head whose input width is not the configured one is drawn afresh
    (seed 0, as JAX draws it from ``PRNGKey(0)``): a warning, not a shape
    error."""
    wide = tproj.ProjectorBank(_small_config(ReasoningCoreConfig), device="cpu").init()
    wide.save_weights(tmp_path / "bank.npz")
    narrow_cfg = _small_config(ReasoningCoreConfig)
    narrow_cfg.audiomae_dim = 8
    bank = tproj.ProjectorBank(narrow_cfg, device="cpu").init()
    before = bank.project_audio(np.ones((1, 8), np.float32))
    bank.load_weights(tmp_path / "bank.npz")
    np.testing.assert_array_equal(bank.project_audio(np.ones((1, 8), np.float32)), before)
    assert bank.project_region(np.ones((2, 24), np.float32)).shape == (2, 32)


def test_perception_loop_renders_the_same_query(banks):
    jax_bank, port_bank = banks
    jt, jk = _scene(jtl, jkb)
    tt, tk = _scene(ttl, tkb)
    jcfg, tcfg = _small_config(JaxConfig), _small_config(ReasoningCoreConfig)
    want_b = _Recording(jcore.TimelineGroundedFakeBackend())
    got_b = _Recording(tcore.TimelineGroundedFakeBackend())
    want_loop = jloop.PerceptionReasoningLoop(
        jcfg, jt, jk, reasoning_core=jcore.ReasoningCore(jcfg, backend=want_b),
        projectors=jax_bank)
    got_loop = tloop.PerceptionReasoningLoop(
        tcfg, tt, tk, reasoning_core=tcore.ReasoningCore(tcfg, backend=got_b, device="cpu"),
        projectors=port_bank, device="cpu")
    rng = np.random.default_rng(1)
    frames = [
        dict(timestamp=1.0, visual_detections=[{"label": "boss", "confidence": 0.95}]),
        dict(timestamp=1.5, visual_detections=[{"label": "boss", "confidence": 0.95}]),
        dict(timestamp=9.0, audio_events=[{"event": "explosion", "confidence": 0.9}],
             ocr_results=[{"text": "HP 40", "confidence": 0.9, "bbox": [1, 2, 3, 4]}],
             audio_embeddings=rng.standard_normal((3, 16)).astype(np.float32)),
        dict(timestamp=20.0, force_reason=True,
             region_embeddings=rng.standard_normal((20, 24)).astype(np.float32),
             audio_embeddings=rng.standard_normal((2, 16)).astype(np.float32)),
    ]
    for loop in (want_loop, got_loop):
        loop.start()
        loop.add_hico_context(0.0, np.zeros(4))
        loop.add_hico_context(6.0, np.zeros(4))
    for i, kw in enumerate(frames):
        if i == 3:
            want_loop.set_query("What is the boss doing?")
            got_loop.set_query("What is the boss doing?")
        want = want_loop.process_frame(**kw)
        got = got_loop.process_frame(**kw)
        assert got == want, kw["timestamp"]
    assert [c for c in got_b.calls] == [c for c in want_b.calls]
    assert got_b.calls and got_b.calls[-1][1] == (18, 32)   # 16 region + 2 audio rows
    assert got_loop.get_status()["pending_triggers"] == want_loop.get_status()["pending_triggers"]


@pytest.mark.parametrize("seed", [77, 1234])
def test_pipeline_samples_equal_jax(seed):
    """BENCH_r05's pipeline samples (n 32 at each seed): every field equal."""
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(32):
        want = jqa.generate_pipeline_sample(jrng)
        got = tqa.generate_pipeline_sample(trng)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert trng.random() == jrng.random()


def test_pipeline_pieces_equal_jax():
    for seed in range(6):
        jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
        assert tqa._asr_garble(trng, "enemy ahead take cover") == \
            jqa._asr_garble(jrng, "enemy ahead take cover")
        assert tqa._loop_suffixes(trng) == jqa._loop_suffixes(jrng)
        jt, jk = jqa._build_pipeline_scene(jrng, 16.0, ["player", "boss"], "the bridge is out",
                                           extra_audio=(7.2, "UI chime"))
        tt, tk = tqa._build_pipeline_scene(trng, 16.0, ["player", "boss"], "the bridge is out",
                                           extra_audio=(7.2, "UI chime"))
        assert tt.build_structured_transcript() == jt.build_structured_transcript()
        assert tk.export_for_llm() == jk.export_for_llm()
    assert tqa._letters_prompt("Q?", ["a", "b"]) == jqa._letters_prompt("Q?", ["a", "b"])


def test_evaluate_pipeline_sends_the_same_prompts():
    """``evaluate_qa_lm(pipeline=True)`` hands the engine the prompts JAX's
    does and scores the same answers the same way (a replaying engine)."""

    class _Engine:
        def __init__(self):
            self.config, self.prompts = tqa.qa_lm_config(), []

        def generate(self, ids, **kw):
            self.prompts.append(list(ids))
            return list(b"**Answer:** A) Yes")

    want_e, got_e = _Engine(), _Engine()
    want = jqa.evaluate_qa_lm(None, jqa.qa_lm_config(), n_samples=6, seed=77, engine=want_e,
                              pipeline=True, max_len=4096)
    got = tqa.evaluate_qa_lm(engine=got_e, n_samples=6, seed=77, pipeline=True, max_len=4096)
    assert got_e.prompts == want_e.prompts
    assert got["accuracy"] == want["accuracy"] and got["by_family"] == want["by_family"]
