"""The port's command-line entry points against the JAX package's scripts,
on the CPU: ``python -m gvl_tpu_torch.scripts.realtime_inference
--device cpu`` (one-shot ``--query``, ``--batched``, the interactive mode
driven from stdin) against ``scripts/realtime_inference.py``, and
``python -m gvl_tpu_torch.scripts.deploy_api`` (``/metrics``, ``--int8``
over a small QA checkpoint, each refusal).

The ``light`` preset (the scripts' default: zero-shot mini-SigLIP labels,
whole-frame embeddings, OCR and audio on the trained weights, the grounded
fake answering) on a 4 s clip.  ``Timeline:`` lines and the interactive
transcript are compared as text.  The web search's two network calls are
stubbed off (``enable_network=False`` and a searcher cache in the test's
directory): no test waits on DNS or on the 8 s timeout.
"""

import http.client
import io
import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.agent import search as jsearch
from gvl_tpu.models.qwen3 import Qwen3Config as JaxQwen3Config
from gvl_tpu.models.qwen3 import Qwen3Model as JaxQwen3Model
from gvl_tpu.training import qa_lm_train as jqa
from gvl_tpu_torch import pipeline as tpipe
from gvl_tpu_torch.agent import search as tsearch
from gvl_tpu_torch.scripts import deploy_api
from gvl_tpu_torch.scripts import realtime_inference as tri

from scripts import realtime_inference as jri

REPO = Path(__file__).resolve().parents[1]
CLIP = "synthetic://cli_demo?duration=4&fps=2&entities=player,boss&audio=1"
QUERY = "Does a boss appear at any point in this video? Answer Yes or No."


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_loops():
    jri._LOOP_COMPONENT_CACHE.clear()
    tpipe._LOOP_COMPONENT_CACHE.clear()
    yield
    jri._LOOP_COMPONENT_CACHE.clear()
    tpipe._LOOP_COMPONENT_CACHE.clear()


def _timeline_line(text: str) -> str:
    return next(line for line in text.splitlines() if line.startswith("Timeline:"))


@pytest.fixture(scope="module")
def one_shot():
    """JAX's script and the port's main in process, ``--query`` on the
    clip, then ``--batched``: their standard outputs."""
    out = {}
    for name, main, extra in (("jax", jri.main, []), ("port", tri.main, ["--device", "cpu"])):
        for mode in ([], ["--batched"]):
            jri._LOOP_COMPONENT_CACHE.clear()
            tpipe._LOOP_COMPONENT_CACHE.clear()
            buf = io.StringIO()
            real = sys.stdout
            sys.stdout = buf
            try:
                assert main(["--video", CLIP, "--no-cache", "--query", QUERY, *mode, *extra]) == 0
            finally:
                sys.stdout = real
            out[name, tuple(mode)] = buf.getvalue()
    return out


def test_one_shot_query_equals_jax(one_shot):
    line = _timeline_line(one_shot["port", ()])
    assert line == _timeline_line(one_shot["jax", ()])
    assert line.startswith("Timeline: ") and "events" in line
    # the grounded fake's answer follows, as JAX's does
    assert one_shot["port", ()].split(line, 1)[1] == one_shot["jax", ()].split(line, 1)[1]
    assert "**Answer:**" in one_shot["port", ()]


def test_batched_query_equals_jax(one_shot):
    got, want = one_shot["port", ("--batched",)], one_shot["jax", ("--batched",)]
    assert _timeline_line(got) == _timeline_line(want)
    assert got.split(_timeline_line(got), 1)[1] == want.split(_timeline_line(want), 1)[1]


def test_module_entry_point_on_the_cpu(one_shot, tmp_path):
    """``python -m gvl_tpu_torch.scripts.realtime_inference --device cpu
    --query ...`` exits 0 with the in-process run's ``Timeline:`` line; a
    missing ``--video`` is a usage error, and ``--device cuda`` without a
    card raises."""
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "2"}
    cmd = [sys.executable, "-m", "gvl_tpu_torch.scripts.realtime_inference", "--video", CLIP,
           "--no-cache", "--query", QUERY]
    result = subprocess.run(cmd + ["--device", "cpu"], capture_output=True, text=True,
                            cwd=REPO, env=env, timeout=300)
    assert result.returncode == 0, result.stderr[-2000:]
    assert _timeline_line(result.stdout) == _timeline_line(one_shot["port", ()])
    usage = subprocess.run(cmd[:3], capture_output=True, text=True, cwd=REPO, env=env,
                           timeout=120)
    assert usage.returncode == 2 and "--video" in usage.stderr
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tri.main(["--video", CLIP, "--no-cache", "--query", QUERY])


def _offline(mod, root):
    class Offline(mod.GameKnowledgeSearcher):
        def __init__(self):
            super().__init__(cache=mod.SearchCache(root / mod.__name__), enable_network=False)

    return Offline


INTERACTIVE = ["/help", "/status", "/game Elden Ring", "/search margit weakness",
               "/boss margit", "", "What happens at 00:02?", "/history", "/bogus", "/clear",
               "/quit", "never read"]


def test_interactive_mode_from_stdin(tmp_path, monkeypatch, capsys):
    """The slash commands and one question, read from stdin as ``input()``
    reads them: the same transcript as JAX's ``interactive_mode`` but for
    the answer's wall time, and no network call."""
    from gvl_tpu_torch.eval.model_configs import get_model_config as port_arm
    from gvl_tpu_torch.eval.model_inference import FullPipelineRunner

    from benchmarks.model_configs import get_model_config as jax_arm
    from benchmarks.model_inference import FullPipelineRunner as JaxRunner

    monkeypatch.setattr(jri, "GameKnowledgeSearcher", _offline(jsearch, tmp_path))
    monkeypatch.setattr(tri, "GameKnowledgeSearcher", _offline(tsearch, tmp_path))

    def no_network(*args, **kw):
        raise AssertionError("the interactive mode reached for the network")

    import urllib.request

    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    clip = "synthetic://cli_chat?duration=2&fps=2&entities=player,enemy"
    jcfg = JaxRunner(jax_arm("qa_lm"), use_cache=False).preset
    tcfg = FullPipelineRunner(port_arm("qa_lm"), use_cache=False, device="cpu").preset
    for cfg in (jcfg, tcfg):
        cfg.perception.sam_backend = cfg.perception.ocr_backend = "fake"
        cfg.audio.event_checkpoint = cfg.audio.asr_checkpoint = None
        cfg.reasoning.llm_checkpoint = None
    transcripts = []
    for module, pv in ((jri, jri.process_video(clip, jcfg, use_cache=False)),
                       (tri, tpipe.process_video(clip, tcfg, use_cache=False, device="cpu"))):
        capsys.readouterr()
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(INTERACTIVE) + "\n"))
        module.interactive_mode(pv)
        out = capsys.readouterr().out
        transcripts.append([ln for ln in out.splitlines() if not ln.startswith("[")])
    want, got = transcripts
    assert got == want
    text = "\n".join(got)
    assert tri.HELP in text and "game set: Elden Ring" in text
    assert text.count("[No search results found]") == 2
    assert "unknown command /bogus" in text and "conversation cleared" in text
    assert "'turn_count'" in text and "never read" not in text


@pytest.fixture(scope="module")
def tiny_qa(tmp_path_factory):
    """A random 2-layer byte QA model (JAX init, seed 0) as a checkpoint."""
    cfg = JaxQwen3Config(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=16, intermediate_size=128, vocab_size=384,
                         max_cache_length=256, rope_theta=100_000.0)
    params = jax.jit(JaxQwen3Model(cfg).init)(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    out = tmp_path_factory.mktemp("tiny_qa")
    jqa.save_qa_lm(jax.tree.map(np.asarray, params["params"]), out, cfg)
    return out


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read() or b"{}")
    conn.close()
    return resp.status, data


@pytest.mark.parametrize("int8", [False, True])
def test_deploy_api_serves_metrics_and_generate(tiny_qa, int8):
    """``/metrics`` (the fields JAX's service reports, plus the engine's
    counters once an LLM is attached) and ``/generate`` over the small QA
    checkpoint, its weights int8 with ``--int8``."""
    from gvl_tpu.serving import api as japi

    argv = ["--port", "0", "--device", "cpu", "--llm-checkpoint", str(tiny_qa),
            "--num-slots", "2"] + (["--int8"] if int8 else [])
    server = deploy_api.build_server(argv)
    engine = server.service._engine_server.engine
    assert engine.config.quant_int8 == int8
    names = set(engine.model.state_dict()) if hasattr(engine, "model") else set()
    if names:
        assert any(n.endswith("weight_q") for n in names) == int8
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        status, metrics = _request(port, "GET", "/metrics")
        gen_status, gen = _request(port, "POST", "/generate",
                                   {"prompt": "Q: boss?\nA:", "max_new_tokens": 4})
        _, after = _request(port, "GET", "/metrics")
    finally:
        server.service._engine_server.shutdown() if hasattr(
            server.service._engine_server, "shutdown") else None
        server.shutdown()
        server.server_close()
        thread.join()
    assert status == 200 and gen_status == 200, gen
    jax_fields = set(japi.InferenceService().metrics())
    assert jax_fields <= set(metrics) and "engine" in metrics
    assert len(gen["tokens"]) <= 4 and isinstance(gen.get("text"), str)
    assert after["engine"] != metrics["engine"]


@pytest.mark.parametrize("argv,label", [
    (["--llm-checkpoint", "{hf}"], "A10"),
    (["--llm-checkpoint", "{hf}", "--int8"], "A10"),
    (["--tp", "2"], "A12"),
    (["--dp", "4"], "A12"),
    (["--llm-checkpoint", "{qa}", "--tp", "2"], "A12"),
])
def test_deploy_api_refusals(tmp_path, tiny_qa, argv, label):
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text("{}")
    argv = [a.format(hf=hf, qa=tiny_qa) for a in argv]
    with pytest.raises(NotImplementedError, match=label):
        deploy_api.build_server(["--port", "0", "--device", "cpu", *argv])
