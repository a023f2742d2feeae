"""gvl_tpu_torch's serving path against gvl_tpu's, on the CPU.

The continuous-batching engine, its threaded server, the HTTP service and
the chat backend's routing.  Weights made by the JAX model are carried
across with ``params_from_jax``; both sides run greedy with an f32 cache,
so token streams (and prefill counts) must be equal.
"""

import dataclasses
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models.qwen3 import Qwen3Config as JaxConfig
from gvl_tpu.models.qwen3 import Qwen3Model as JaxModel
from gvl_tpu.serving.batch_engine import ContinuousBatchingEngine as JaxBatchEngine
from gvl_tpu_torch.agent.config import ReasoningCoreConfig
from gvl_tpu_torch.agent.core import Qwen3ChatBackend
from gvl_tpu_torch.models import qwen3 as port
from gvl_tpu_torch.models.byte_tokenizer import ByteTokenizer
from gvl_tpu_torch.models.convert import params_from_jax
from gvl_tpu_torch.models.session import Qwen3ChatSession
from gvl_tpu_torch.serving import (
    ContinuousBatchingEngine,
    EngineServer,
    InferenceService,
    create_server,
)
from gvl_tpu_torch.serving.engine_server import EngineError

PROMPTS = [[7, 3, 99], [1, 45, 206, 77], [5, 5, 5]]
F32 = dict(dtype=torch.float32, device="cpu")


def _model(**kw):
    jcfg = JaxConfig.tiny(max_cache_length=64, **kw)
    tcfg = port.Qwen3Config.tiny(max_cache_length=64, **kw)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = {"params": params["params"]}
    return jcfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray, params), tcfg)


@pytest.fixture(scope="module")
def tiny():
    return _model()


def _engine(tcfg, state, slots=2, eos=-1):
    return ContinuousBatchingEngine(tcfg, state, eos_token_id=eos, num_slots=slots,
                                    temperature=0.0, **F32)


def _single(tcfg, state, prompt, n, eos=-1):
    return port.Qwen3Engine(tcfg, state, eos_token_id=eos, **F32).generate(
        prompt, max_new_tokens=n, temperature=0.0)


def _jax_engine(jcfg, params, slots=2, eos=-1):
    return JaxBatchEngine(jcfg, params, eos_token_id=eos, num_slots=slots,
                          dtype=jnp.float32, temperature=0.0)


# ------------------------------------------------------------ batch engine

def test_more_requests_than_slots_match_jax_and_single_requests(tiny):
    """Three requests through two slots with different budgets: queueing,
    slot reuse, and an idle slot stepping beside a live one."""
    jcfg, tcfg, params, state = tiny
    budgets = [6, 2, 5]
    engine, jax_engine = _engine(tcfg, state), _jax_engine(jcfg, params)
    ids = [engine.submit(p, n) for p, n in zip(PROMPTS, budgets)]
    jids = [jax_engine.submit(p, n) for p, n in zip(PROMPTS, budgets)]
    got, want = engine.run(), jax_engine.run()
    assert [got[i] for i in ids] == [want[i] for i in jids]
    assert [got[i] for i in ids] == [_single(tcfg, state, p, n)
                                     for p, n in zip(PROMPTS, budgets)]
    assert not engine.has_work


def test_eos_frees_the_slot(tiny):
    _, tcfg, _, state = tiny
    eos = _single(tcfg, state, PROMPTS[0], 1)[0]
    engine = _engine(tcfg, state, slots=1, eos=eos)
    first = engine.submit(PROMPTS[0], max_new_tokens=8)
    second = engine.submit(PROMPTS[1], max_new_tokens=3)
    results = engine.run()
    assert results[first] == []                  # stopped at EOS at once
    assert results[second] == _single(tcfg, state, PROMPTS[1], 3, eos)
    produced = engine.step()
    assert produced == {} and not engine.has_work


def test_slot_prefix_reuse_and_its_overflow_fallback_match_jax(tiny):
    """A returning session prefills only its delta; a delta whose bucket
    would run past the cache takes a full prefill from offset 0."""
    jcfg, tcfg, params, state = tiny
    engine, jax_engine = _engine(tcfg, state, slots=1), _jax_engine(jcfg, params, 1)

    def turn(prompt, n=4):
        rid, jrid = engine.submit(prompt, n, "alice"), jax_engine.submit(prompt, n, "alice")
        out, jout = engine.run()[rid], jax_engine.run()[jrid]
        assert out == jout == _single(tcfg, state, prompt, n)
        prefilled = engine._requests[rid].prefilled
        assert prefilled == jax_engine._requests[jrid].prefilled
        return out, prefilled

    out1, prefilled = turn(PROMPTS[0])
    assert prefilled == len(PROMPTS[0])
    transcript = PROMPTS[0] + out1 + [17, 4]
    out2, prefilled = turn(transcript)
    # the new turn plus the last answer token, which ended the request
    # before it was fed
    assert prefilled == 3
    transcript = transcript + out2
    out3, prefilled = turn(transcript)          # the transcript exactly
    assert prefilled == 1
    # a 33-token delta buckets to 64: offset + 64 > 64 rows, full prefill
    long = transcript + out3 + list(range(10, 43))
    _, prefilled = turn(long, 2)
    assert prefilled == len(long)


@pytest.mark.parametrize("head_dim", [16, 128])
def test_scan_layers_engine_matches_unrolled_and_jax(head_dim):
    jcfg, tcfg, params, state = _model(head_dim=head_dim)
    want = _engine(tcfg, state).generate_many(PROMPTS, max_new_tokens=4)
    scan_cfg = dataclasses.replace(tcfg, scan_layers=True)
    engine = _engine(scan_cfg, port.stack_layers(state, tcfg))
    assert engine.cache.stacked
    assert engine.generate_many(PROMPTS, max_new_tokens=4) == want
    if head_dim == 128:
        jscan = dataclasses.replace(jcfg, scan_layers=True)
        jtree = JaxModel(jscan).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        jax_engine = _jax_engine(jscan, {"params": jtree["params"]})
        scan_state = params_from_jax(jax.tree.map(np.asarray, jtree), scan_cfg)
        assert (_engine(scan_cfg, scan_state).generate_many(PROMPTS, 4)
                == jax_engine.generate_many(PROMPTS, max_new_tokens=4))
    # a returning session's delta into the stacked cache
    rid = engine.submit(PROMPTS[0], 3, session_key="s")
    transcript = PROMPTS[0] + engine.run()[rid] + [9, 8]
    rid = engine.submit(transcript, 3, session_key="s")
    assert engine.run()[rid] == _single(tcfg, state, transcript, 3)
    assert engine._requests[rid].prefilled == 3


def test_prefill_failure_fails_only_its_request(tiny, monkeypatch):
    _, tcfg, _, state = tiny
    engine = _engine(tcfg, state)
    real = engine._prefill
    tripped = []

    def flaky(slot, delta):
        if not tripped:
            tripped.append(slot)
            raise RuntimeError("injected prefill error")
        return real(slot, delta)

    monkeypatch.setattr(engine, "_prefill", flaky)
    bad = engine.submit(PROMPTS[0], 4)
    good = engine.submit(PROMPTS[1], 4)
    results = engine.run()
    assert "injected prefill error" in engine._requests[bad].error
    assert results[bad] == []
    assert engine._requests[good].error is None
    assert results[good] == _single(tcfg, state, PROMPTS[1], 4)
    engine.reset_cache()
    assert engine.generate_many(PROMPTS[:2], 4) == [
        _single(tcfg, state, p, 4) for p in PROMPTS[:2]]


def test_submit_limits_and_unported_mesh(tiny):
    _, tcfg, _, state = tiny
    engine = _engine(tcfg, state, slots=1)
    with pytest.raises(ValueError, match="max_cache_length"):
        engine.submit(list(range(60)), max_new_tokens=8)
    engine.submit([1, 2, 3], max_new_tokens=tcfg.max_cache_length - 4)
    with pytest.raises(NotImplementedError, match="A12"):
        ContinuousBatchingEngine(tcfg, state, mesh=object(), **F32)


# ------------------------------------------------------------ engine server

def test_engine_server_concurrent_streams_and_failure_isolation(tiny):
    _, tcfg, _, state = tiny
    expected = [_single(tcfg, state, p, 5) for p in PROMPTS]
    engine = _engine(tcfg, state)
    server = EngineServer(engine)
    try:
        results = [None] * len(PROMPTS)

        def worker(i):
            results[i] = list(server.submit_stream(PROMPTS[i], max_new_tokens=5))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert results == expected
        stats = server.stats()
        assert stats["requests_completed"] == 3 and stats["tokens_generated"] == 15
        assert stats["slots_total"] == 2 and stats["ttft_ms_p50"] is not None

        # a failed decode step fails the live stream; the driver serves on
        real_step, calls = engine.step, []

        def flaky_step():
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("injected device error")
            return real_step()

        engine.step = flaky_step
        with pytest.raises(EngineError, match="injected device error"):
            server.generate(PROMPTS[0], max_new_tokens=4)
        tokens, prefilled = server.generate_with_info(PROMPTS[1], max_new_tokens=4)
        assert tokens == expected[1][:4] and prefilled == len(PROMPTS[1])
    finally:
        server.shutdown()
    assert not server._driver.is_alive()


# ------------------------------------------------------------ HTTP service

def _request(port_, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port_, timeout=120)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, (json.loads(data) if data.startswith(b"{") else data)
    finally:
        conn.close()


def test_http_service_on_localhost(tiny):
    _, tcfg, _, state = tiny
    service = InferenceService()
    engine_server = EngineServer(_engine(tcfg, state))
    service.attach_engine(
        engine_server, tokenizer=ByteTokenizer(),
        session_factory=lambda: Qwen3ChatSession(tcfg, state, eos_token_id=-1, **F32))
    httpd = create_server("127.0.0.1", 0, service=service)
    port_ = httpd.server_address[1]
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    try:
        prompts = PROMPTS + [[9, 8, 7, 6, 5]]
        expected = [_single(tcfg, state, p, 4) for p in prompts]
        replies = [None] * 4

        def post(i):
            replies[i] = _request(port_, "POST", "/generate",
                                  {"prompt_ids": prompts[i], "max_new_tokens": 4})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [r[0] for r in replies] == [200] * 4
        assert [r[1]["tokens"] for r in replies] == expected

        status, turn1 = _request(port_, "POST", "/chat", {
            "session_id": "u1", "prompt_ids": PROMPTS[1], "max_new_tokens": 4})
        assert status == 200 and turn1["prefilled"] == len(PROMPTS[1])
        transcript = PROMPTS[1] + turn1["tokens"] + [30, 31, 32]
        status, turn2 = _request(port_, "POST", "/chat", {
            "session_id": "u1", "prompt_ids": transcript, "max_new_tokens": 4})
        assert status == 200 and turn2["prefilled"] == 3
        assert turn2["tokens"] == _single(tcfg, state, transcript, 4)

        status, stream = _request(port_, "POST", "/generate/stream",
                                  {"prompt_ids": PROMPTS[0], "max_new_tokens": 3})
        assert status == 200
        assert [int(x) for x in stream.split()] == expected[0][:3]
        status, metrics = _request(port_, "GET", "/metrics")
        assert status == 200 and metrics["chat_sessions"] == 1
        assert metrics["engine"]["requests_completed"] == 5
        assert _request(port_, "GET", "/health")[1]["llm_engine"] is True
        assert _request(port_, "POST", "/generate", {"max_new_tokens": 2})[0] == 400
        # the video routes run process_video on the service's device, the
        # card by default: without one it refuses, never falling back
        status, reply = _request(port_, "POST", "/query",
                                 {"video": "clip.mp4", "question": "?"})
        assert status == 500 and "device='cpu'" in reply["error"]
        assert _request(port_, "GET", "/nowhere")[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine_server.shutdown()
        serving.join(timeout=10)
    assert not serving.is_alive()


def test_chat_sessions_evict_least_recently_used(tiny):
    _, tcfg, _, state = tiny
    service = InferenceService()
    made = []

    def factory():
        made.append(Qwen3ChatSession(tcfg, state, eos_token_id=-1, **F32))
        return made[-1]

    service.attach_engine(None, session_factory=factory)
    service.max_sessions = 2
    for sid in ("a", "b", "a", "c"):
        service.chat({"session_id": sid, "prompt_ids": [1, 2, 3], "max_new_tokens": 1})
    assert list(service._sessions) == ["a", "c"]     # "b" was least recent
    assert made[1].cache is None                      # evicted: tensors dropped
    assert made[0].cache_nbytes() == 2 * 2 * 2 * 64 * 16 * 4


# ------------------------------------------------------------ backend routing

class _Fake:
    def __init__(self, tag, calls):
        self.tag, self.calls = tag, calls

    def stream(self, ids, **kw):
        self.calls.append((self.tag, sorted(kw)))
        yield from ByteTokenizer().encode(self.tag)


def test_backend_routes_spec_engine_then_session_then_engine():
    calls = []
    engine, spec, session = (_Fake(t, calls) for t in ("engine", "spec", "session"))
    messages = [{"role": "user", "content": "hi"}]
    cfg = ReasoningCoreConfig(max_new_tokens=8, temperature=0.0)
    prefix = np.zeros((2, 16), np.float32)
    route = [
        (Qwen3ChatBackend(engine, ByteTokenizer(), spec_engine=spec, session=session), None, "spec"),
        (Qwen3ChatBackend(engine, ByteTokenizer(), session=session), None, "session"),
        (Qwen3ChatBackend(engine, ByteTokenizer()), None, "engine"),
        # an embedding prefix always takes the plain engine
        (Qwen3ChatBackend(engine, ByteTokenizer(), spec_engine=spec, session=session),
         prefix, "engine"),
    ]
    for backend, pre, tag in route:
        assert "".join(backend.stream(messages, cfg, inputs_embeds_prefix=pre)) == tag
    assert [c[0] for c in calls] == ["spec", "session", "engine", "engine"]
    assert "inputs_embeds_prefix" in calls[-1][1]
    assert "inputs_embeds_prefix" not in calls[0][1]
