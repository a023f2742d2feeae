"""The port's phase runners and perception cache against the JAX package's,
on the CPU, on the trained weights of ``outputs/``.

``run_phase1`` (``gvp_light``; the ``qa_lm`` arm is in
``test_torch_eval_qa_lm.py``), ``run_phase2`` and ``run_phase3`` run
in process through each package's ``main(argv)``, each from a working
directory of its own (the perception and feature caches live there):
per sample the same ``predicted``, ``correct``, frames and output words,
and the same aggregate accuracy.  One clip through both runners' perception
cache gives the same files, arrays within 1e-4 and the same JSON (the
clock stopped: both write it into ``created_at`` and the KB's
``exported_at``): byte for byte where no model confidence is written, and
with the zero-shot labels' f32 confidences within 1e-4 (``sam_entities``,
``timeline``); a cold runner rebuilds from the port's cache without perception and answers
as the warm one did.
"""

import json
import time

import numpy as np
import pytest
import torch

from benchmarks import run_phase1 as j1
from benchmarks import run_phase2 as j2
from benchmarks import run_phase3 as j3
from benchmarks.model_configs import get_model_config as jax_arm
from benchmarks.model_inference import FullPipelineRunner as JaxRunner
from benchmarks.perception_cache import PerceptionCache as JaxCache
from gvl_tpu_torch import pipeline as tpipe
from gvl_tpu_torch.eval import run_phase1 as t1
from gvl_tpu_torch.eval import run_phase2 as t2
from gvl_tpu_torch.eval import run_phase3 as t3
from gvl_tpu_torch.eval.loaders import BenchmarkSample
from gvl_tpu_torch.eval.model_configs import get_model_config as port_arm
from gvl_tpu_torch.eval.model_inference import FullPipelineRunner
from gvl_tpu_torch.eval.perception_cache import PerceptionCache

from scripts import realtime_inference as jri

ARRAY_TOL = 1e-4
CONF_TOL = 1e-4      # zero-shot label confidences, f32 in both packages


def assert_same_doc(got, want, where=""):
    """Two parsed JSON documents: equal, floats within CONF_TOL."""
    if isinstance(want, float) and isinstance(got, float):
        assert abs(got - want) <= CONF_TOL, where
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for key in want:
            assert_same_doc(got[key], want[key], f"{where}/{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_doc(g, w, f"{where}[{i}]")
    else:
        assert got == want, where
SAMPLE_KEYS = ("sample_id", "benchmark", "config_name", "task_type", "predicted",
               "ground_truth", "correct", "num_frames", "output_tokens", "error")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_both(tmp_path, monkeypatch, jax_main, port_main, argv, phase):
    """Each package's main(argv) from its own working directory; returns
    (JAX's, port's) (samples.json, aggregates.json)."""
    out = {}
    for name, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        workdir = tmp_path / name
        workdir.mkdir()
        monkeypatch.chdir(workdir)
        assert main(argv + ["--output-dir", "results"] + extra) == 0
        out[name] = tuple(json.loads((workdir / "results" / phase / f).read_text())
                          for f in ("samples.json", "aggregates.json"))
    return out["jax"], out["port"]


def assert_same_results(want, got, n_samples):
    (w_samples, w_aggs), (g_samples, g_aggs) = want, got
    assert len(g_samples) == len(w_samples) == n_samples
    assert [{k: s[k] for k in SAMPLE_KEYS} for s in g_samples] == [
        {k: s[k] for k in SAMPLE_KEYS} for s in w_samples]
    assert not any(s["error"] for s in g_samples)
    keys = ("config_name", "benchmark", "num_samples", "num_correct", "num_errors",
            "accuracy", "avg_frames", "avg_output_tokens", "by_task")
    assert [{k: a[k] for k in keys} for a in g_aggs] == [{k: a[k] for k in keys} for a in w_aggs]


def test_run_phase1_gvp_light_as_jax(tmp_path, monkeypatch):
    argv = ["--synthetic", "--max-samples", "2", "--benchmark", "glitchbench",
            "--configs", "gvp_light"]
    want, got = run_both(tmp_path, monkeypatch, j1.main, t1.main, argv, "phase1")
    assert_same_results(want, got, 2)
    assert got[1][0]["hbm_source"] == "none"


def test_run_phase2_as_jax(tmp_path, monkeypatch):
    want, got = run_both(tmp_path, monkeypatch, j2.main, t2.main,
                         ["--synthetic", "--max-samples", "1"], "phase2")
    assert_same_results(want, got, 1)


def test_run_phase3_with_duration_filters_as_jax(tmp_path, monkeypatch):
    """Both loaders of phase 3 (LongVideoBench, MLVU), one sample each, the
    duration filters on."""
    want, got = run_both(tmp_path, monkeypatch, j3.main, t3.main,
                         ["--synthetic", "--max-samples", "1", "--min-duration", "5",
                          "--max-duration", "30"], "phase3")
    assert_same_results(want, got, 2)
    assert {s["benchmark"] for s in got[0]} == {"longvideobench", "mlvu"}


CLIP = "synthetic://stageab?duration=6&fps=2&entities=player,enemy"


def test_perception_cache_of_a_clip_as_jax_and_cold_rebuild(tmp_path, monkeypatch):
    jri._LOOP_COMPONENT_CACHE.clear()
    tpipe._LOOP_COMPONENT_CACHE.clear()
    monkeypatch.setattr(time, "time", lambda: 1.8e9)
    want_cache, got_cache = JaxCache(tmp_path / "jax"), PerceptionCache(tmp_path / "port")
    JaxRunner(jax_arm("gvp_light"), use_cache=False,
              perception_cache=want_cache)._get_processed(CLIP)

    def port_runner():
        return FullPipelineRunner(port_arm("gvp_light"), use_cache=False,
                                  perception_cache=got_cache, device="cpu")

    warm = port_runner()
    warm_processed = warm._get_processed(CLIP)
    w_entry, g_entry = want_cache._entry(CLIP), got_cache._entry(CLIP)
    assert g_entry.name == w_entry.name
    names = sorted(p.name for p in w_entry.iterdir())
    assert sorted(p.name for p in g_entry.iterdir()) == names
    assert {"metadata.json", "timeline.json", "kb.json", "siglip.npz"} <= set(names)
    for name in names:
        w, g = w_entry / name, g_entry / name
        if name in ("sam_entities.json", "timeline.json"):
            assert_same_doc(json.loads(g.read_text()), json.loads(w.read_text()), name)
        elif name.endswith(".json"):
            assert g.read_bytes() == w.read_bytes(), name
        else:
            with np.load(w) as a, np.load(g) as b:
                assert b["data"].shape == a["data"].shape, name
                if a["data"].size:
                    np.testing.assert_allclose(b["data"], a["data"], rtol=0, atol=ARRAY_TOL)

    sample = BenchmarkSample(sample_id="s", benchmark_name="t", video_path=CLIP,
                             question="Does an enemy appear in this video? Answer Yes or No.")
    answer = warm.run_inference(sample)

    def boom(*a, **k):
        raise AssertionError("perception re-ran on a cache hit")

    monkeypatch.setattr(tpipe, "process_video", boom)
    cold = port_runner()
    rebuilt = cold._get_processed(CLIP)
    assert rebuilt.loop is not None and rebuilt is not warm_processed
    assert rebuilt.timestamps == warm_processed.timestamps
    assert (rebuilt.timeline.build_structured_transcript()
            == warm_processed.timeline.build_structured_transcript())
    again = cold.run_inference(sample)
    assert "error" not in again and again["raw_response"]
    assert (again["predicted"], again["raw_response"]) == (answer["predicted"],
                                                          answer["raw_response"])


def test_c13_a_cold_process_prompts_as_the_warm_one(tmp_path):
    """ROADMAP C13.  A benchmark's Stage B in a process that wrote the
    perception cache (every clip built before the first answer, the answers
    in one conversation) against a process that rebuilds every clip from
    that cache: JAX's rebuild keeps only the knowledge base's entity names
    and clears the conversation at each clip; the port's rebuilds the whole
    knowledge base and keeps the conversation, so the reasoning core is
    handed the same messages and answers alike.  The ``synthetic_gate`` arm
    (the trained segmenter: entity states and relationships) on three
    synthetic samples."""
    from benchmarks.loaders import BenchmarkConfig as JaxConfig
    from benchmarks.loaders import GlitchBenchLoader as JaxLoader
    from gvl_tpu_torch.eval.loaders import BenchmarkConfig, GlitchBenchLoader
    from gvl_tpu_torch.utils.profiler import MessageLog

    samples = GlitchBenchLoader(BenchmarkConfig(synthetic=True, max_samples=3)).load()
    cache = PerceptionCache(tmp_path / "port")

    def serve():
        runner = FullPipelineRunner(port_arm("synthetic_gate"), use_cache=False,
                                    perception_cache=cache, device="cpu")
        for s in samples:                  # Stage A (a no-op on the cold side)
            if not cache.has(s.video_path):
                runner._get_processed(s.video_path)
        log, results = None, []
        for s in samples:                  # Stage B
            core = runner._get_processed(s.video_path).loop.reasoning_core
            if log is None:
                log = core.backend = MessageLog(core.backend)
            results.append(runner.run_inference(s))
        core.backend = log.backend
        kbs = [runner._processed[s.video_path].knowledge_base.export_for_llm() for s in samples]
        return results, log.messages, kbs

    tpipe._LOOP_COMPONENT_CACHE.clear()
    warm, warm_messages, warm_kbs = serve()
    tpipe._LOOP_COMPONENT_CACHE.clear()   # a new process: a new reasoning core
    cold, cold_messages, cold_kbs = serve()
    tpipe._LOOP_COMPONENT_CACHE.clear()
    assert cold_kbs == warm_kbs and any("at (" in kb for kb in warm_kbs)
    assert len(cold_messages) == len(samples) and cold_messages == warm_messages
    assert [r["raw_response"] for r in cold] == [r["raw_response"] for r in warm]
    assert not any("error" in r for r in warm + cold)

    # JAX's cold rebuild of the first clip: the entity positions are gone
    jri._LOOP_COMPONENT_CACHE.clear()
    jax_cache = JaxCache(tmp_path / "jax")
    video = JaxLoader(JaxConfig(synthetic=True, max_samples=1)).load()[0].video_path
    assert video == samples[0].video_path
    jax_warm = JaxRunner(jax_arm("synthetic_gate"), use_cache=False,
                         perception_cache=jax_cache)._get_processed(video)
    jax_cold = JaxRunner(jax_arm("synthetic_gate"), use_cache=False,
                         perception_cache=jax_cache)._get_processed(video)
    jri._LOOP_COMPONENT_CACHE.clear()
    assert jax_warm.knowledge_base.export_for_llm() == warm_kbs[0]
    assert jax_cold.knowledge_base.export_for_llm() != warm_kbs[0]
