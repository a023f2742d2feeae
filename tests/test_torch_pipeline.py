"""gvl_tpu_torch's ``process_video`` / ``answer_query``, the HTTP video
routes and the segmenter ladder against ``scripts/realtime_inference.py``
and gvl_tpu's service, on the CPU, at a small size (the arm on the trained
weights is ``tests/test_torch_arm.py``).

- A small random QA model written as a checkpoint and served by both
  stacks in f32, greedy: prompts and answers equal token for token.
- ``POST /process``, ``/query``, ``/query/stream`` and ``GET /timeline`` on
  127.0.0.1 answer as JAX's service does (deterministic backends).
- ROADMAP C7: the port's ladder refuses an unusable segmenter checkpoint
  (JAX segments with random weights there:
  ``tests/test_torch_segmenter.py``).
- The options that are not ported raise, naming their ROADMAP item.
"""

import http.client
import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.model_configs import get_model_config as jax_arm
from benchmarks.model_inference import FullPipelineRunner as JaxRunner
from gvl_tpu.models.qwen3 import Qwen3Config as JaxQwen3Config
from gvl_tpu.models.qwen3 import Qwen3Engine as JaxEngine
from gvl_tpu.models.qwen3 import Qwen3Model as JaxQwen3Model
from gvl_tpu.perception import batch as jbatch
from gvl_tpu.serving import api as japi
from gvl_tpu.training import qa_lm_train as jqa
from gvl_tpu_torch import pipeline as tpipe
from gvl_tpu_torch.eval.model_configs import get_model_config as port_arm
from gvl_tpu_torch.eval.model_inference import FullPipelineRunner
from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
from gvl_tpu_torch.models.qwen3 import Qwen3Engine
from gvl_tpu_torch.perception import batch as tbatch
from gvl_tpu_torch.serving import api as tapi
from gvl_tpu_torch.training import qa_lm_train as tqa
from gvl_tpu_torch.utils.profiler import PromptLog

from scripts import realtime_inference as jri

QUESTIONS = ["Does a boss appear at any point in this video? Answer Yes or No.",
             "What does the voice in this clip say? Pick the option matching the spoken "
             "line.\n\nOptions:\nA) enemy ahead take cover\nB) press the button now\n"
             "C) grab the key and run\nD) the bridge is out\n\nAnswer with the letter of "
             "the correct option."]


@pytest.fixture(autouse=True, scope="module")
def one_thread_fresh_caches():
    """One torch thread, and the loops' per-process component caches emptied
    before and after: these tests change the cached cores' engines."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jri._LOOP_COMPONENT_CACHE.clear()
    tpipe._LOOP_COMPONENT_CACHE.clear()
    yield
    jri._LOOP_COMPONENT_CACHE.clear()
    tpipe._LOOP_COMPONENT_CACHE.clear()
    torch.set_num_threads(threads)


def _f32_engines(jax_pv, port_pv, ckpt):
    """Both loops' QA engines rebuilt in f32 from ``ckpt``, behind recorders."""
    jcfg, jparams = jqa.load_qa_lm(ckpt)
    jax_backend = jax_pv.loop.reasoning_core.backend
    jax_backend.engine = PromptLog(JaxEngine(jcfg, {"params": jparams}, eos_token_id=EOS_ID,
                                            dtype=jnp.float32))
    tcfg, state = tqa.load_qa_lm(ckpt, device="cpu")
    port_backend = port_pv.loop.reasoning_core.backend
    port_backend.engine = PromptLog(Qwen3Engine(tcfg, state, eos_token_id=EOS_ID,
                                               dtype=torch.float32, device="cpu"))
    return jax_backend.engine, port_backend.engine


def _events(timeline):
    return [(e.timestamp, e.modality.value, e.description, e.priority.value, e.duration,
             e.entity_id) for e in timeline.events]


@pytest.fixture(scope="module")
def tiny_qa(tmp_path_factory):
    """A random 2-layer byte QA model (JAX init, seed 0) as a checkpoint.  Its
    1024-token cache makes both chat backends middle-trim the arm's 2.5k-4k
    byte prompts, the path an over-long prompt takes."""
    cfg = JaxQwen3Config(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=16, intermediate_size=128, vocab_size=384,
                         max_cache_length=1024, rope_theta=100_000.0,
                         tie_word_embeddings=False)
    params = JaxQwen3Model(cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    out = tmp_path_factory.mktemp("tiny_qa")
    jqa.save_qa_lm(jax.tree.map(np.asarray, params["params"]), out, cfg)
    return out


def _tiny_presets(ckpt):
    """The arm's wiring with fake perception (no checkpoints) and ``ckpt``."""
    presets = []
    for runner in (JaxRunner(jax_arm("qa_lm"), use_cache=False),
                   FullPipelineRunner(port_arm("qa_lm"), use_cache=False, device="cpu")):
        cfg = runner.preset
        cfg.perception.sam_backend = "fake"
        cfg.perception.ocr_backend = "fake"
        cfg.audio.event_checkpoint = cfg.audio.asr_checkpoint = None
        cfg.reasoning.projector_path = None
        cfg.reasoning.llm_checkpoint = str(ckpt) if ckpt else None
        cfg.reasoning.max_new_tokens = 24
        presets.append(cfg)
    return presets


def test_tiny_qa_model_answers_exactly(tiny_qa):
    jcfg, tcfg = _tiny_presets(tiny_qa)
    clip = "synthetic://concept_demo_tiny?duration=4&fps=2&entities=player,enemy&audio=1"
    jax_pv = jri.process_video(clip, jcfg, use_cache=False)
    port_pv = tpipe.process_video(clip, tcfg, use_cache=False, device="cpu")
    assert _events(port_pv.timeline) == _events(jax_pv.timeline)
    want_e, got_e = _f32_engines(jax_pv, port_pv, tiny_qa)
    for pv in (jax_pv, port_pv):
        pv.loop.reasoning_core.config.temperature = 0.0
    for q in (QUESTIONS[0], "What happens at 00:02?"):
        want = jri.answer_query(jax_pv, q, jax_pv.loop.reasoning_core.retriever
                                .parse_timestamp(q))
        got = tpipe.answer_query(port_pv, q, port_pv.loop.reasoning_core.retriever
                                 .parse_timestamp(q))
        assert got_e.prompts[-1] == want_e.prompts[-1]
        assert got == want, q
    want = list(jri.answer_query_streaming(jax_pv, "and then?"))
    got = list(tpipe.answer_query_streaming(port_pv, "and then?"))
    assert "".join(got) == "".join(want)


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_http_video_routes_answer_as_jax():
    jcfg, tcfg = _tiny_presets(None)
    clip = "synthetic://concept_demo_http?duration=4&fps=2&entities=player,item"
    answers = []
    for server in (japi.create_server(port=0, config=jcfg),
                   tapi.create_server(port=0, service=tapi.InferenceService(tcfg, "cpu"))):
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        try:
            got = [_request(port, "POST", "/process", {"video": clip}),
                   _request(port, "POST", "/query", {
                       "video": clip, "question": "Does an item appear? Answer Yes or No."}),
                   _request(port, "POST", "/query/stream", {
                       "video": clip, "question": "What happens at 00:02?"}),
                   _request(port, "GET", f"/timeline?video={clip}"),
                   _request(port, "GET", "/timeline")]
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        answers.append(got)
    want, got = answers
    assert [s for s, _ in got] == [s for s, _ in want] == [200, 200, 200, 200, 400]
    assert got == want
    assert b"Yes" in got[1][1]


def test_c7_the_arms_ladder_refuses_an_unusable_checkpoint(tmp_path):
    """ROADMAP C7, decided: a segmenter checkpoint that resolves but does
    not hold the model's geometry, or cannot be read, makes the port's
    ``build_segmenter`` raise where JAX's segments with random weights
    (held by ``tests/test_torch_segmenter.py::
    test_wrong_geometry_checkpoint_falls_back_to_random_weights_as_jax``).
    Without a checkpoint both take the fake."""
    wrong = tmp_path / "sam_params.npz"
    np.savez(wrong, **{"params/decoder/queries": np.zeros((3, 4), np.float32)})
    unreadable = tmp_path / "broken.npz"
    unreadable.write_bytes(b"not an npz")
    jcfg, tcfg = _tiny_presets(None)
    for cfg in (jcfg, tcfg):
        cfg.perception.sam_backend = "auto"
    for bad in (wrong, unreadable):
        tcfg.perception.sam_checkpoint = str(bad)
        with pytest.raises(ValueError, match="C7"):
            tbatch.build_segmenter(tcfg, device="cpu")
    for cfg in (jcfg, tcfg):
        cfg.perception.sam_checkpoint = str(tmp_path / "absent.npz")
    assert (type(tbatch.build_segmenter(tcfg, device="cpu").backend).__name__
            == type(jbatch.build_segmenter(jcfg).backend).__name__
            == "DeterministicFakeSegmenter")
    # the open-vocab rung needs the segmenter checkpoint too: without it
    # both fall back to "auto", and so to the fake
    for cfg in (jcfg, tcfg):
        cfg.perception.sam_backend = "open_vocab"
    assert (type(tbatch.build_segmenter(tcfg, device="cpu").backend).__name__
            == type(jbatch.build_segmenter(jcfg).backend).__name__
            == "DeterministicFakeSegmenter")


def test_unported_options_raise(tmp_path):
    """Batched and pipelined perception, refused before they were ported
    (ROADMAP A14), now run and give JAX's timeline here (on the fake
    encoders; on the trained weights: ``tests/test_torch_batched.py``), as
    do SigLIP, VideoMAE and HiCo (the trained HiCo file).  What still
    raises names its item: an HF LLM checkpoint (A10) and more than one
    device for the LLM (A12)."""
    from gvl_tpu_torch.scripts import deploy_api

    jcfg, tcfg = _tiny_presets(None)
    clip = "synthetic://concept_demo_x?duration=2"
    for kw, stage in (({"batched": True}, "batched_perception"),
                      ({"pipelined": True}, "pipelined_perception")):
        want = jri.process_video(clip, jcfg, use_cache=False, **kw)
        got = tpipe.process_video(clip, tcfg, use_cache=False, device="cpu", **kw)
        assert stage in got.timings
        assert _events(got.timeline) == _events(want.timeline)
    tcfg.perception.use_siglip = tcfg.perception.use_videomae = True
    tcfg.temporal.use_hico = True
    tcfg.perception.siglip_checkpoint = tcfg.perception.videomae_checkpoint = None
    pv = tpipe.process_video(clip, tcfg, use_cache=False, device="cpu")
    assert {"siglip_embeddings", "videomae_embeddings", "temporal_compression"} <= set(pv.timings)
    assert {t for t, _ in pv.siglip_embeddings} == set(pv.timestamps) == {0.0, 1.0}
    assert any(e.description.startswith("Temporal context") for e in pv.timeline.events)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.process_video(clip, tcfg)
    hf = tmp_path / "hf_qwen3"
    hf.mkdir()
    (hf / "config.json").write_text("{}")
    tcfg.reasoning.llm_checkpoint = str(hf)
    tpipe._LOOP_COMPONENT_CACHE.clear()
    with pytest.raises(NotImplementedError, match="A10"):
        tpipe.process_video(clip, tcfg, use_cache=False, device="cpu")
    for argv, label in ((["--llm-checkpoint", str(hf)], "A10"),
                        (["--tp", "2"], "A12"), (["--dp", "2"], "A12"),
                        (["--llm-checkpoint", str(hf), "--tp", "2"], "A12")):
        with pytest.raises(NotImplementedError, match=label):
            deploy_api.build_server(["--port", "0", "--device", "cpu", *argv])


def test_random_checkpoints_take_the_trained_layouts_and_ladders(tmp_path):
    """The checkpoints the card writes in place of ``outputs/`` hold the
    trained files' key paths and shapes (``checkpoint_layouts.json``), load
    back as the state dicts they were drawn from, and make every ladder of
    the arm resolve to its model."""
    from gvl_tpu_torch.audio.processor import build_audio_stack
    from gvl_tpu_torch.perception.encoders import write_random_checkpoints
    from gvl_tpu_torch.perception.segmenter import _checkpoint_state

    outputs = Path(__file__).resolve().parents[1] / "outputs"
    ckpts = write_random_checkpoints(tmp_path, "cpu", seed=3)
    for written, trained in ((ckpts.segmenter, outputs / "sam_params.npz"),
                             (ckpts.events, outputs / "audio_event_params.npz"),
                             (Path(ckpts.asr) / "params.npz", outputs / "asr" / "params.npz"),
                             (Path(ckpts.retriever) / "params.npz",
                              outputs / "retriever" / "params.npz")):
        with np.load(written) as a, np.load(trained) as b:
            assert {k: a[k].shape for k in a.files} == {k: b[k].shape for k in b.files}
    assert (json.loads((Path(ckpts.asr) / "asr_config.json").read_text())["model"]
            == json.loads((outputs / "asr" / "asr_config.json").read_text())["model"])
    state = _checkpoint_state(ckpts.segmenter, 256)
    again = _checkpoint_state(write_random_checkpoints(tmp_path / "again", "cpu",
                                                       seed=3).segmenter, 256)
    assert all(torch.equal(v, again[k]) for k, v in state.items())
    _, cfg = _tiny_presets(None)
    cfg.perception.sam_backend = "auto"
    cfg.perception.sam_checkpoint = ckpts.segmenter
    cfg.audio.event_checkpoint, cfg.audio.asr_checkpoint = ckpts.events, ckpts.asr
    assert type(tbatch.build_segmenter(cfg, device="cpu").backend).__name__ == \
        "TorchSegmenterBackend"
    proc, _ = build_audio_stack(cfg.audio, device="cpu")
    assert (type(proc.asr).__name__, type(proc.event_backend).__name__) == \
        ("TrainedByteASR", "TorchAudioEventDetector")


def test_c8_the_arms_hico_rung_refuses_an_unusable_file(tmp_path, monkeypatch):
    """ROADMAP C8, settled as C7: where ``outputs/hico_params.npz`` resolves
    (the working directory first) but is not of the module's shapes, the
    port's arm rung (``pipeline.run_hico``) raises where JAX's compresses
    with a random initialisation; where no file resolves both compress on
    their random initialisation (one HiCo event each)."""
    from gvl_tpu.temporal import hico as jhico
    from gvl_tpu_torch.fusion import TimelineIndexer as TTimeline
    from gvl_tpu_torch.temporal import hico as thico

    from gvl_tpu.fusion import TimelineIndexer as JTimeline

    frames = [(i / 2, f) for i, f in enumerate(np.random.default_rng(9).integers(
        0, 256, (6, 24, 32, 3), dtype=np.uint8))]
    jcfg, tcfg = _tiny_presets(None)
    for cfg in (jcfg, tcfg):
        cfg.temporal.use_hico = True
        cfg.inference.fps = 2.0
    (tmp_path / "outputs").mkdir()
    trained = thico.load_hico_npz(Path(__file__).resolve().parents[1] / "outputs"
                                  / "hico_params.npz")
    trained["params"]["temporal_pe"] = trained["params"]["temporal_pe"][:, :64]
    thico.save_hico_npz(trained, tmp_path / "outputs" / "hico_params.npz")
    monkeypatch.chdir(tmp_path)
    jtl = JTimeline()
    assert len(jri.run_hico(frames, jtl, jcfg)) == 1        # JAX: random init, a warning
    with pytest.raises(ValueError, match="C8"):
        tpipe.run_hico(frames, TTimeline(), tcfg, device="cpu")
    monkeypatch.setattr(jhico, "_resolve_checkpoint", lambda path: None)
    monkeypatch.setattr(thico, "_resolve_checkpoint", lambda path: None)
    jtl, ttl = JTimeline(), TTimeline()
    assert len(jri.run_hico(frames, jtl, jcfg)) == len(tpipe.run_hico(
        frames, ttl, tcfg, device="cpu")) == 1
    assert [e.description[:16] for e in ttl.events] == [e.description[:16] for e in jtl.events]
