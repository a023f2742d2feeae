"""The multi-device entry points of gvl_tpu_torch, on the CPU.

``entry.dryrun_multichip(4)`` inside one world of four gloo processes (the
JAX dry run's checks, each against its unsharded run, and its two lines);
the DP x TP LoRA step at 2 x 2, where the gradients are also summed over
data; the batching engine at DP x TP (greedy equal to JAX's, sampled
streams equal to the unsharded port engine's: every rank draws every
slot's random numbers); the 8B shard plan at model 2 and 4 (JAX's nine must-shard paths);
C17 (both packages' trainers keep a mesh and read it nowhere: the same
weights with and without one); and ``deploy_api --tp 2`` launched as
torchrun launches it, two processes on the CPU, answering four concurrent
``POST /generate`` as the unsharded server does.
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
from gvl_tpu.parallel import build_mesh
from gvl_tpu.serving.batch_engine import ContinuousBatchingEngine as JaxBatch
from gvl_tpu.training import lora_train as jlora
from gvl_tpu.training import qa_lm_train as jqa
from gvl_tpu_torch.models import qwen3 as tq
from gvl_tpu_torch.models.convert import params_to_jax
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


def test_batch_engine_dp_tp_matches_jax_and_unsharded(world):
    """Five prompts on four slots (a queue, slots freed and reused): greedy
    tokens at 2 x 2 equal to JAX's engine and to the unsharded port's; a
    sampled run (T 0.7) at 2 x 2 and 4 x 1 equal to the unsharded port
    engine's; returning sessions prefill only their delta, as unsharded."""
    jcfg, params, tcfg, state = _models()
    jax_engine = JaxBatch(jcfg, {"params": params}, eos_token_id=-1, num_slots=4,
                          dtype=jnp.float32, temperature=0.0)
    want = jax_engine.generate_many(PROMPTS, max_new_tokens=5)
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


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/generate", body=json.dumps(body),
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


def test_deploy_api_tp2_under_torchrun_answers_as_unsharded(tiny_qa, tmp_path):
    from gvl_tpu_torch.scripts import deploy_api

    server = deploy_api.build_server(["--port", "0", "--device", "cpu", "--num-slots", "4",
                                      "--llm-checkpoint", str(tiny_qa)])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with ThreadPoolExecutor(4) as pool:
            want = list(pool.map(lambda b: _post(server.server_address[1], b), BODIES))
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
        os.kill(pid, signal.SIGTERM)       # rank 0 releases its follower and both exit
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert [s for s, _ in got] == [200] * 4
    assert [d["tokens"] for _, d in got] == [d["tokens"] for _, d in want]
    assert [d["text"] for _, d in got] == [d["text"] for _, d in want]
