"""The multi-device entry points of gvl_tpu_torch, on the CPU.

``entry.dryrun_multichip(4)`` inside one world of four gloo processes (the
JAX dry run's checks, each against its unsharded run, and its two lines);
the DP x TP LoRA step at 2 x 2, where the gradients are also summed over
data; the batching engine at DP x TP (greedy equal to JAX's, sampled
streams equal to the unsharded port engine's: every rank draws every
slot's random numbers); the 8B shard plan at model 2 and 4 (JAX's nine must-shard paths);
C17 (both packages' trainers keep a mesh and read it nowhere: the same
weights with and without one); chat sessions in the engine's lockstep
step (C18) and failures agreed on by every rank (C19: a failed prefill
fails its request alone; C20: a failed decode step fails the live
requests and every rank serves on); and ``deploy_api --tp 2`` launched as
torchrun launches it, two processes on the CPU, answering four concurrent
``POST /generate`` and a session's two ``POST /chat`` turns as the
unsharded server does.
"""

import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models import qwen3 as jq
from gvl_tpu.models.sam import hash_tokenize
from gvl_tpu.models.session import Qwen3ChatSession as JaxSession
from gvl_tpu.parallel import build_mesh
from gvl_tpu.serving.batch_engine import ContinuousBatchingEngine as JaxBatch
from gvl_tpu.training import lora_train as jlora
from gvl_tpu.training import qa_lm_train as jqa
from gvl_tpu_torch.models import qwen3 as tq
from gvl_tpu_torch.models.byte_tokenizer import ByteTokenizer
from gvl_tpu_torch.models.convert import params_to_jax
from gvl_tpu_torch.models.session import Qwen3ChatSession as TorchSession
from gvl_tpu_torch.parallel.mesh import MeshManager
from gvl_tpu_torch.training import lora_train as tlora

import torch_mp_cases as cases
from test_torch_tensor_parallel import _models
from torch_world import World

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


def test_dryrun_multichip_in_a_world(world):
    """The dry run's two lines from rank 0, the JAX dry run's fields."""
    out = world.run(cases.dryrun, 4)
    lines = out[0].strip().splitlines()
    assert all(o == "" for o in out[1:]) and len(lines) == 2
    assert lines[0].startswith("dryrun_multichip OK: mesh={'data': 1, 'model': 4} batch=2 ")
    for field in ("loss=", "tp_int8_decode=", "dp_perception_frames=3", "dp_tp_serving="):
        assert field in lines[0]
    assert re.match(r"8B shard plan OK: model=4 params_sharded=9 ", lines[1])


def test_dp_tp_lora_step_sums_gradients_over_data(world):
    """At 2 x 2 each replica takes half the batch: the loss and every
    updated shard equal the one-process step's (the function raises
    otherwise), the same loss on every rank."""
    losses = world.run(cases.lora_step, 2, 2)
    assert len(set(losses)) == 1 and np.isfinite(losses[0])


@pytest.mark.parametrize("model", [2, 4])
def test_8b_shard_plan(world, model):
    assert world.run(cases.plan_8b, model) == [9] * 4


PROMPTS = [[7, 3, 99], [1, 45, 206, 77], [5, 5, 5], [8, 1], [300, 2, 9, 9, 4]]


@pytest.fixture(scope="module")
def tiny_models():
    return _models()


@pytest.fixture(scope="module")
def jax_greedy(tiny_models):
    """JAX's batching engine's greedy tokens of PROMPTS (four slots, five
    tokens each)."""
    jcfg, params, _, _ = tiny_models
    return JaxBatch(jcfg, {"params": params}, eos_token_id=-1, num_slots=4,
                    dtype=jnp.float32, temperature=0.0).generate_many(PROMPTS, 5)


def test_batch_engine_dp_tp_matches_jax_and_unsharded(world, tiny_models, jax_greedy):
    """Five prompts on four slots (a queue, slots freed and reused): greedy
    tokens at 2 x 2 equal to JAX's engine and to the unsharded port's; a
    sampled run (T 0.7) at 2 x 2 and 4 x 1 equal to the unsharded port
    engine's; returning sessions prefill only their delta, as unsharded."""
    _, _, tcfg, state = tiny_models
    want = jax_greedy
    alone = cases.batch_generate(tcfg, state, 1, 1, PROMPTS, 5)
    assert alone == want
    assert world.run(cases.batch_generate, tcfg, state, 2, 2, PROMPTS, 5) == [want] * 4
    sampled = cases.batch_generate(tcfg, state, 1, 1, PROMPTS, 5, temperature=0.7)
    assert sampled != want
    for data, model in ((2, 2), (4, 1)):
        assert world.run(cases.batch_generate, tcfg, state, data, model, PROMPTS, 5,
                         temperature=0.7) == [sampled] * 4
    rounds = cases.batch_generate(tcfg, state, 1, 1, PROMPTS[:4], 4, sessions=True)
    assert rounds[2] == [2] * 4     # the last answer token and the new one
    assert world.run(cases.batch_generate, tcfg, state, 2, 2, PROMPTS[:4], 4,
                     sessions=True) == [rounds] * 4


def jax_sessions(jcfg, params, prompts, n):
    """JAX's answers to the turns of ``cases.lockstep_sessions`` (session a's
    two turns, then b's) and each turn's prefilled count."""
    out = []
    session = JaxSession(jcfg, {"params": params}, eos_token_id=-1, dtype=jnp.float32)
    for i, tail in ((0, [5, 6]), (1, [7])):
        session.reset()      # b is a new session (its compiled steps kept)
        first = session.generate(prompts[i], max_new_tokens=n, temperature=0.0)
        out.append((first, session.last_ingested))
        second = session.generate(prompts[i] + first + tail, max_new_tokens=n,
                                  temperature=0.0)
        out.append((second, session.last_ingested))
    return out


def test_lockstep_sessions_match_jax_at_2x2(world, tiny_models, jax_greedy):
    """C18: chat turns run in the engine's step on every rank at 2 x 2,
    beside ``generate`` requests: JAX's session tokens and prefilled counts
    (a second turn prefills only its delta), one eviction at
    ``max_sessions`` 1, the same table and transcripts on every rank, the
    requests JAX's engine's tokens; a sampled run (T 0.7) equal to the
    unsharded port engine's turns."""
    jcfg, params, tcfg, state = tiny_models
    want = jax_sessions(jcfg, params, PROMPTS, 5)
    sampled, = cases.lockstep_sessions(tcfg, state, 1, 1, PROMPTS, 5, (0.7,))
    assert sampled["turns"] != want
    got = world.run(cases.lockstep_sessions, tcfg, state, 2, 2, PROMPTS, 5, (0.0, 0.7))
    assert got[0][0]["turns"] == want
    b_said = PROMPTS[1] + want[2][0] + [7] + want[3][0]     # b's transcript; a evicted
    for out, _ in got:
        assert out["tables"] == [["a"], ["b"], ["b"]] and out["cached"] == {"b": b_said}
        assert out["generated"] == jax_greedy
    assert got[0][1]["turns"] == sampled["turns"]
    assert [o["generated"] for _, o in got] == [sampled["generated"]] * 4


@pytest.fixture(scope="module")
def jax_two_slots(tiny_models):
    """JAX's batching engine on two slots (its compiled steps kept between
    the tests that trip its prefill)."""
    jcfg, params, _, _ = tiny_models
    return JaxBatch(jcfg, {"params": params}, eos_token_id=-1, num_slots=2,
                    dtype=jnp.float32, temperature=0.0)


def _jax_trips(engine, calls, monkeypatch):
    """JAX's engine whose prefill raises at the given call numbers (as its
    ``TestPrefillFailureAttribution`` wraps ``_delta_prefill_fn``)."""
    real, count = engine._delta_prefill_fn, [0]

    def flaky(size):
        fn = real(size)

        def wrapped(*a, **k):
            count[0] += 1
            if count[0] in calls:
                raise RuntimeError("injected prefill trace error")
            return fn(*a, **k)

        return wrapped

    monkeypatch.setattr(engine, "_delta_prefill_fn", flaky)


@pytest.mark.parametrize("where, bad", [("every", 0), ("owner", 1)])
def test_prefill_failure_fails_only_its_request_on_every_rank(world, tiny_models, jax_two_slots,
                                                             monkeypatch, where, bad):
    """C19 at 2 x 2: the first request's prefill fails on every rank, or
    the second's on its slot's replica only (ranks 2 and 3: rank 0 learns
    it from the admission's gather).  The offender alone fails, on every
    rank; the other request and the run after give JAX's tokens (JAX's
    engine with the same prefill failing); sampled (T 0.7), the run equals
    the unsharded port engine's."""
    _, _, tcfg, state = tiny_models
    prompts = PROMPTS[:3]
    jax_engine = jax_two_slots
    _jax_trips(jax_engine, {bad + 1}, monkeypatch)
    ids = [jax_engine.submit(p, 4) for p in prompts[:2]]
    results = jax_engine.run()
    want = {"first": [(results[i], jax_engine._requests[i].error is not None) for i in ids],
            "after": jax_engine.generate_many(prompts, 4)}
    assert [failed for _, failed in want["first"]] == [i == bad for i in range(2)]
    sampled, = cases.prefill_failure(tcfg, state, 1, 1, prompts, 4, where, bad, (0.7,))
    assert world.run(cases.prefill_failure, tcfg, state, 2, 2, prompts, 4, where, bad,
                     (0.0, 0.7)) == [[want, sampled]] * 4


def test_decode_failure_fails_live_requests_and_every_rank_serves_on(world, tiny_models,
                                                                   jax_greedy):
    """C20 at 2 x 2, on the served path (rank 0's engine server, the other
    ranks following): the decode step with both slots live fails on every
    rank; both requests fail on every rank, every cache is rebuilt, and the
    next requests give JAX's tokens (greedy: its first four of five).
    Before it, a chat session that rank 1 alone cannot open fails its turn
    on every rank (no rank's table keeps it), and its next turn answers as
    the unsharded port session."""
    _, _, tcfg, state = tiny_models
    want = [tokens[:4] for tokens in jax_greedy[:3]]
    got = world.run(cases.decode_failure, tcfg, state, 2, 2, PROMPTS[:3], 4)
    session = TorchSession(tcfg, state, eos_token_id=-1, dtype=torch.float32, device="cpu")
    failed, answered = got[0]["chat"]
    assert "another rank could not open the session" in failed
    assert answered == (session.generate(PROMPTS[0], max_new_tokens=4, temperature=0.0),
                        len(PROMPTS[0]))
    assert [o["sessions"] for o in got] == [["s"]] * 4
    failed = got[0]["failed"]
    assert all("injected device error" in f for f in failed) and len(failed) == 2
    assert got[0]["after"] == want
    assert [o["tripped"] for o in got] == [1] * 4
    assert all(o["errors"] == got[0]["errors"] for o in got)
    assert sorted(got[0]["errors"].values()) == [False] * 3 + [True] * 2


def _chat():
    words = ["boss", "player", "health", "potion", "cave", "attack"]
    rng = np.random.RandomState(0)
    return [{"messages": [{"role": "user", "content": " ".join(rng.choice(words, 5))},
                          {"role": "assistant", "content": " ".join(rng.choice(words, 8))}]}
            for _ in range(2)]


def test_c17_trainers_keep_the_mesh_and_read_it_nowhere(tmp_path):
    """ROADMAP C17: JAX's LoraTrainer takes ``mesh=`` and only stores it;
    the port keeps that.  JAX's trainer given an 8-device mesh trains as the
    port's without one (which ``tests/test_torch_train_lora.py`` holds to
    JAX's without one), and the port's gives bit-equal weights with a mesh
    and without."""
    cfg = jq.Qwen3Config.tiny(lora_rank=4, max_cache_length=64)
    tcfg = tq.Qwen3Config.tiny(lora_rank=4, max_cache_length=64)
    # Flax's laws drawn by the port (no JAX compile), carried into JAX's tree
    state = tq.init_jax_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    params = params_to_jax(state, tcfg)
    data = _chat()

    def tokenize(text):
        return hash_tokenize(text, cfg.vocab_size, 48).tolist()

    def config(lib, out):
        return lib.LoraTrainingConfig(learning_rate=1e-2, grad_accum_steps=1, epochs=1,
                                      max_seq_len=24, output_dir=str(out), save_steps=100)

    mesh = build_mesh(8, 1)
    trainer = jlora.LoraTrainer(jq.Qwen3Model(cfg), params, tokenize,
                                config(jlora, tmp_path / "jax"), mesh=mesh)
    assert trainer.mesh is mesh
    trainer.train(data)
    with np.load(tmp_path / "jax" / "adapter_final.npz") as z:
        jax_weights = {k: z[k] for k in z.files}
    port_weights = []
    for i, mesh in enumerate((None, MeshManager.single_device(device="cpu"))):
        trainer = tlora.LoraTrainer(tcfg, {k: v.clone() for k, v in state.items()}, tokenize,
                                    config(tlora, tmp_path / f"port{i}"), mesh=mesh,
                                    device="cpu")
        assert trainer.mesh is mesh
        trainer.train(data)
        port_weights.append({k: v.clone() for k, v in trainer.params.items()})
    for k in port_weights[0]:
        assert torch.equal(port_weights[0][k], port_weights[1][k]), k
        key = tq._jax_key(k, tcfg)
        if key in jax_weights:
            np.testing.assert_allclose(port_weights[0][k].numpy(), jax_weights[key],
                                       atol=1e-5, rtol=0)
    assert any(k.endswith("lora_b") for k in jax_weights)
    from gvl_tpu_torch.training.projector_train import ProjectorTrainer

    marker = MeshManager.single_device(device="cpu")
    assert ProjectorTrainer(mesh=marker, device="cpu").mesh is marker


# ------------------------------------------------------- deploy_api --tp 2

@pytest.fixture(scope="module")
def tiny_qa(tmp_path_factory):
    """A random 2-layer byte QA model (JAX init) whose KV heads (2) and MLP
    divide over 2 ranks."""
    cfg = jq.Qwen3Config(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=16, intermediate_size=128, vocab_size=384,
                         max_cache_length=256, rope_theta=100_000.0)
    params = jax.jit(jq.Qwen3Model(cfg).init)(jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32))
    out = tmp_path_factory.mktemp("tiny_qa")
    jqa.save_qa_lm(jax.tree.map(np.asarray, params["params"]), out, cfg)
    return out


def _post(port, body, path="/generate"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read() or b"{}")
    conn.close()
    return resp.status, data


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


BODIES = [{"prompt": p, "max_new_tokens": 6} for p in
          ("Where is the boss?", "Is the player low on health?", "What drops?",
           "Name the cave.")]


def _chat_turns(port) -> list:
    """A session's two ``POST /chat`` turns (the second extends the first's
    transcript)."""
    first_ids = ByteTokenizer().encode("Where is the boss?")
    first = _post(port, {"session_id": "u1", "prompt_ids": first_ids,
                         "max_new_tokens": 6}, "/chat")
    second_ids = first_ids + first[1]["tokens"] + ByteTokenizer().encode(" And now?")
    second = _post(port, {"session_id": "u1", "prompt_ids": second_ids,
                          "max_new_tokens": 6}, "/chat")
    return [first, second]


def test_deploy_api_tp2_under_torchrun_answers_as_unsharded(tiny_qa, tmp_path):
    from gvl_tpu_torch.scripts import deploy_api

    server = deploy_api.build_server(["--port", "0", "--device", "cpu", "--num-slots", "4",
                                      "--llm-checkpoint", str(tiny_qa)])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with ThreadPoolExecutor(4) as pool:
            want = list(pool.map(lambda b: _post(server.server_address[1], b), BODIES))
        want_chat = _chat_turns(server.server_address[1])
    finally:
        server.shutdown()
        server.server_close()
        deploy_api.stop_engine(server)
        thread.join()
    port = _free_port()
    log = tmp_path / "torchrun.log"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    with open(log, "w") as sink:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "gvl_tpu_torch.scripts.deploy_api",
             "--tp", "2", "--device", "cpu", "--port", str(port), "--num-slots", "4",
             "--llm-checkpoint", str(tiny_qa)],
            cwd=tmp_path, env=env, stdout=sink, stderr=subprocess.STDOUT,
            start_new_session=True)
    try:
        deadline, pid = time.time() + 120, None
        while pid is None and time.time() < deadline and proc.poll() is None:
            found = re.search(r"serving on 127\.0\.0\.1:\d+ \(pid (\d+)\)", log.read_text())
            pid = int(found.group(1)) if found else None
            time.sleep(0.2)
        assert pid is not None, log.read_text()[-3000:]
        assert "1x2 = 2 cpu device(s); gloo" in log.read_text()
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda b: _post(port, b), BODIES))
        got_chat = _chat_turns(port)
        os.kill(pid, signal.SIGTERM)       # rank 0 releases its follower and both exit
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert [s for s, _ in got] == [200] * 4
    assert [d["tokens"] for _, d in got] == [d["tokens"] for _, d in want]
    assert [d["text"] for _, d in got] == [d["text"] for _, d in want]
    # C18: the session's turns run in lockstep on both ranks; the second
    # prefills only its delta
    assert [s for s, _ in got_chat] == [s for s, _ in want_chat] == [200] * 2
    for key in ("tokens", "text", "prefilled"):
        assert [d[key] for _, d in got_chat] == [d[key] for _, d in want_chat], key
    assert want_chat[1][1]["prefilled"] == 9
