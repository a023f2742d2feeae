"""The port's evaluation host code against the JAX package's, on the CPU:
the loaders (``gvl_tpu_torch/eval/loaders`` against ``benchmarks/loaders``)
over the same local datasets, the metrics tracker's JSON, the perception
cache's files, answer parsing and ``eval_harness``'s example and mock runs.

Loaders give the same samples field by field; ``samples.json`` and
``aggregates.json`` are equal except timings and the device-memory fields
(JAX reads its runtime's statistics, the port the card's allocator and
nothing on the CPU); cache files carry the same names and bytes except
their creation times.
"""

import json

import numpy as np
import pytest

import benchmarks.loaders as jl
from benchmarks import eval_harness as jharness
from benchmarks import metrics as jmetrics
from benchmarks import perception_cache as jcache
from benchmarks.model_inference import check_correctness as jcheck
from benchmarks.model_inference import parse_answer as jparse
from gvl_tpu_torch.eval import eval_harness as tharness
from gvl_tpu_torch.eval import loaders as tl
from gvl_tpu_torch.eval import metrics as tmetrics
from gvl_tpu_torch.eval import perception_cache as tcache
from gvl_tpu_torch.eval import samples as tsamples
from gvl_tpu_torch.eval.model_inference import check_correctness, parse_answer

TIMING_KEYS = ("perception_time_sec", "retrieval_time_sec", "generation_time_sec",
               "total_time_sec", "avg_perception_time", "avg_retrieval_time",
               "avg_generation_time", "avg_total_time")
MEMORY_KEYS = ("peak_hbm_bytes", "peak_hbm_gb", "hbm_source")


def sample_fields(sample) -> dict:
    """Every field of a sample, enums by value."""
    out = dict(vars(sample))
    out["task_type"] = sample.task_type.value
    out["answer_format"] = sample.answer_format.value
    return out


def both(loader: str, **config):
    """The same loader of each package over the same config: (JAX's, port's)."""
    return (getattr(jl, loader)(jl.BenchmarkConfig(**config)),
            getattr(tl, loader)(tl.BenchmarkConfig(**config)))


def assert_same_samples(jax_loader, port_loader):
    want = [sample_fields(s) for s in jax_loader.load()]
    got = [sample_fields(s) for s in port_loader.load()]
    assert got == want and want
    assert port_loader.get_statistics() == jax_loader.get_statistics()


def _physgame(root):
    (root / "annotations.json").write_text(json.dumps([
        {"id": "p1", "video": "v1.mp4", "class": "mechanics", "answer": "gravity",
         "question": "what violation?"},
        {"video": "/abs/v2.mp4", "domain": "optics", "subclass": "shadow", "duration": 12.5},
        {"video": "synthetic://pg?duration=4", "class": "unknown",
         "options": ["a", "b"], "answer": "b"}]))


def _videogameqa(root):
    (root / "glitch_detection.json").write_text(json.dumps(
        [{"question": "q?", "answer": "Yes", "image": "i.png"}]))
    (root / "bug_report.json").write_text(json.dumps(
        [{"question": "report?", "answer": "text"}]))
    (root / "needle_in_haystack_video.json").write_text(json.dumps({"samples": [
        {"id": "n1", "prompt": "find it", "choices": ["x", "y"], "media": "n1.mp4",
         "game": "g", "duration": 30}]}))
    (root / "custom_task.json").write_text(json.dumps(
        [{"question": "c?", "options": ["o1", "o2"], "ground_truth": "o1", "video": "c.y4m"}]))


def _mlvu(root):
    (root / "1_plotQA.json").write_text(json.dumps([
        {"question": "a", "answer": "x", "duration": 200, "candidates": ["x", "y"],
         "video": "a.mp4"},
        {"question": "b", "answer": "y", "duration": 4000, "candidates": ["x", "y"]}]))
    (root / "2_needle.json").write_text(json.dumps([
        {"question": "n", "answer": "free", "duration": 500}]))


def _glitchbench_scan(root):
    (root / "images").mkdir()
    for name in ("g1.png", "g0.jpg", "notes.txt"):
        (root / "images" / name).write_bytes(b"fake")


def _glitchbench_json(root):
    (root / "annotations.json").write_text(json.dumps({"annotations": [
        {"id": "gb1", "image": "x.png", "answer": "No", "game": "skyrim",
         "description": "floating horse"},
        {"video_path": "synthetic://gb?duration=4", "category": "physics"}]}))


def _longvideobench(root):
    (root / "lvb_val.json").write_text(json.dumps([
        {"id": "l1", "candidates": ["a", "b", "c"], "correct_choice": 2,
         "video_path": "l1.mp4", "question": "what?", "question_category": "T3O",
         "duration": 900, "starting_timestamp_for_subtitles": 12.0},
        {"options": ["x"], "answer": "x", "video_id": "/abs/l2.mp4"}]))


DATASETS = {
    "physgame": ("PhysGameLoader", _physgame, {}),
    "videogameqa": ("VideoGameQALoader", _videogameqa, {}),
    "videogameqa_task_filter": ("VideoGameQALoader", _videogameqa,
                                {"tasks": ["bug_report", "glitch_detection"]}),
    "mlvu_duration_filter": ("MLVULoader", _mlvu, {"max_duration_sec": 1000}),
    "mlvu_min_duration": ("MLVULoader", _mlvu, {"min_duration_sec": 300}),
    "glitchbench_dir_scan": ("GlitchBenchLoader", _glitchbench_scan, {}),
    "glitchbench_json": ("GlitchBenchLoader", _glitchbench_json, {}),
    "longvideobench": ("LongVideoBenchLoader", _longvideobench, {"shuffle": True}),
}


@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_loaders_read_local_datasets_as_jax(tmp_path, dataset):
    loader, write, config = DATASETS[dataset]
    write(tmp_path)
    assert_same_samples(*both(loader, data_dir=str(tmp_path), **config))


@pytest.mark.parametrize("loader", ["GlitchBenchLoader", "PhysGameLoader", "VideoGameQALoader",
                                    "LongVideoBenchLoader", "MLVULoader"])
def test_synthetic_fallback_as_jax(loader):
    """No dataset on disk: 16 grounded synthetic samples (the clips' audio
    truths drawn by each package's own ``SyntheticVideo``), shuffled."""
    assert_same_samples(*both(loader, data_dir="/nonexistent", synthetic=True,
                              max_samples=16, shuffle=True, random_seed=3))


def test_eval_samples_keeps_its_names():
    """``eval.samples`` names the loaders' schema; ``SyntheticLoader`` draws
    what a loader of that name and seed draws in its synthetic mode."""
    assert tsamples.BenchmarkSample is tl.BenchmarkSample
    assert tsamples.AnswerFormat is tl.AnswerFormat
    want = jl.GlitchBenchLoader(jl.BenchmarkConfig(random_seed=7)).synthetic_samples(8)
    got = tsamples.SyntheticLoader("glitchbench", 7).synthetic_samples(8)
    assert [sample_fields(s) for s in got] == [sample_fields(s) for s in want]


def test_export_jsonl_as_jax(tmp_path):
    jax_loader, port_loader = both("PhysGameLoader", data_dir="/nonexistent", synthetic=True,
                                   max_samples=4)
    jax_loader.export_jsonl(tmp_path / "jax.jsonl")
    port_loader.export_jsonl(tmp_path / "port.jsonl")
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()


RESPONSES = ["The answer is B.", "(C)", "clearly a collision issue",
             "**Reasoning:** A is tempting...\n**Answer:** B) collision",
             "Yes, there is a glitch at [00:10].", "There is no glitch in this footage.",
             "I do not see any bug here.", "", "something else entirely"]


@pytest.mark.parametrize("response", RESPONSES)
def test_answer_parsing_as_jax(response):
    for fmt, options, truth in (("MCQ", ["gravity", "collision", "motion", "no violation"],
                                 "collision"),
                                ("MCQ", ["gravity", "collision"], "B"),
                                ("BINARY", ["Yes", "No"], "Yes"),
                                ("FREE_TEXT", [], "collision")):
        samples = [pkg.BenchmarkSample(sample_id="s", benchmark_name="t", options=options,
                                       ground_truth=truth,
                                       answer_format=getattr(pkg.AnswerFormat, fmt))
                   for pkg in (jl, tl)]
        want = jparse(response, samples[0])
        assert parse_answer(response, samples[1]) == want
        assert check_correctness(want, samples[1]) == jcheck(want, samples[0])


def _drive_tracker(tracker):
    tracker.start_sample("s1", "bench", "cfg", task_type="visual_qa")
    tracker.record_stage("generation", 1.5)
    tracker.record_stage("perception", 0.25)
    tracker.record_stage("nonexistent", 9.0)
    tracker.end_sample(predicted="Yes", ground_truth="Yes", correct=True, num_frames=10,
                       input_tokens=100, output_tokens=7)
    tracker.start_sample("s2", "bench", "cfg", task_type="glitch_detection")
    tracker.end_sample(predicted="No", ground_truth="Yes", correct=False, num_frames=4)
    tracker.start_sample("s3", "bench", "cfg")
    tracker.end_sample(error="boom")
    tracker.start_sample("s1", "other", "cfg2")
    tracker.end_sample(predicted="A", ground_truth="A", correct=True)
    return tracker.save_results("exp")


def _strip(doc):
    if isinstance(doc, list):
        return [_strip(d) for d in doc]
    return {k: v for k, v in doc.items() if k not in TIMING_KEYS + MEMORY_KEYS}


def test_tracker_json_as_jax(tmp_path, capsys):
    want = _drive_tracker(jmetrics.MetricsTracker(tmp_path / "jax"))
    got = _drive_tracker(tmetrics.MetricsTracker(tmp_path / "port", device="cpu"))
    for name in ("samples.json", "aggregates.json"):
        w, g = (json.loads((d / name).read_text()) for d in (want, got))
        assert _strip(g) == _strip(w)
        assert all(set(x) == set(y) for x, y in zip(g, w))   # JAX's layout, every key
    assert (got / "summary.txt").read_text() == (want / "summary.txt").read_text()
    aggs = json.loads((got / "aggregates.json").read_text())
    assert {a["hbm_source"] for a in aggs} == {"none"} and {a["peak_hbm_gb"] for a in aggs} == {0.0}
    assert tmetrics._device_peak_bytes("cpu") is None and tmetrics._device_peak_bytes() is None
    tracker = tmetrics.MetricsTracker(tmp_path / "p2", device="cpu")
    jtracker = jmetrics.MetricsTracker(tmp_path / "j2")
    for t in (jtracker, tracker):
        _drive_tracker(t)
        t.print_summary()
        t.print_comparison_table()
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2

    def no_memory(lines):   # the summary's peak_hbm figure is the runtime's own
        return [line.split(" peak_hbm=")[0] for line in lines]

    assert no_memory(out[half:]) == no_memory(out[:half])


def test_tracker_reads_the_cards_allocator(monkeypatch, tmp_path):
    """On a CUDA device the tracker records the allocator's high-water mark
    (``allocator_peak``); the call is stubbed here, where no card is."""
    import torch

    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device: 3 * 1024 ** 3)
    tracker = tmetrics.MetricsTracker(tmp_path, device=torch.device("cuda", 0))
    tracker.start_sample("s", "b", "c")
    assert tracker.end_sample(correct=True).peak_hbm_bytes == 3 * 1024 ** 3
    agg = tracker.compute_aggregates()[0]
    assert (agg.peak_hbm_gb, agg.hbm_source) == (3.0, "allocator_peak")


def _cache_entry(pkg, root):
    cache = pkg.PerceptionCache(root)
    arrays = {"siglip": np.arange(24, dtype=np.float32).reshape(3, 8) / 7,
              "videomae": np.zeros((0,), np.float32)}
    artifacts = {"timeline": {"events": [{"t": 1.5, "d": "boss"}]}, "kb": {"entities": []}}
    cache.save("synthetic://v?duration=4", arrays, artifacts)
    cache.save("video.mp4", artifacts={"x": {}})
    cache.invalidate("video.mp4")
    return cache


def test_perception_cache_files_as_jax(tmp_path):
    want = _cache_entry(jcache, tmp_path / "jax")
    got = _cache_entry(tcache, tmp_path / "port")
    assert tcache.CACHE_VERSION == jcache.CACHE_VERSION
    assert tcache.ARRAY_KEYS == jcache.ARRAY_KEYS and tcache.JSON_KEYS == jcache.JSON_KEYS
    for url in ("synthetic://v?duration=4", "video.mp4", str(tmp_path)):
        assert tcache.video_cache_key(url) == jcache.video_cache_key(url)
    w_entry, g_entry = (c._entry("synthetic://v?duration=4") for c in (want, got))
    assert g_entry.name == w_entry.name
    assert sorted(p.name for p in g_entry.iterdir()) == sorted(p.name for p in w_entry.iterdir())
    for path in w_entry.iterdir():
        other = g_entry / path.name
        if path.name == "metadata.json":
            w, g = (json.loads(p.read_text()) for p in (path, other))
            assert {k: v for k, v in g.items() if k != "created_at"} == {
                k: v for k, v in w.items() if k != "created_at"}
        elif path.suffix == ".json":
            assert other.read_bytes() == path.read_bytes()
        else:
            with np.load(path) as a, np.load(other) as b:
                np.testing.assert_array_equal(b["data"], a["data"])
    index = [json.loads((c.cache_dir / "index.json").read_text()) for c in (want, got)]
    assert {k: v["entry"] for k, v in index[1].items()} == {
        k: v["entry"] for k, v in index[0].items()}
    assert got.get_statistics()["num_entries"] == want.get_statistics()["num_entries"] == 1
    assert got.load("video.mp4") is None
    got.clear()
    assert got.get_statistics()["num_entries"] == 0 and not got.has("synthetic://v?duration=4")


def test_eval_harness_example_and_mock_as_jax(tmp_path, monkeypatch):
    """``--generate-example`` writes the same bytes; ``--mock`` scores them
    with the same aggregates (timings and memory fields aside)."""
    for name, harness, extra in (("jax", jharness, []), ("port", tharness, ["--device", "cpu"])):
        out = tmp_path / name
        out.mkdir()
        assert harness.main(["--generate-example", str(out / "example.json"), "--n", "12",
                             "--benchmark", str(out / "example.json"), "--mock",
                             "--output-dir", str(out / "results")] + extra) == 0
    assert ((tmp_path / "port" / "example.json").read_bytes()
            == (tmp_path / "jax" / "example.json").read_bytes())
    for doc in ("aggregates.json", "samples.json"):
        w, g = (json.loads((tmp_path / n / "results" / "eval_harness" / doc).read_text())
                for n in ("jax", "port"))
        assert _strip(g) == _strip(w)
    assert json.loads((tmp_path / "port" / "results" / "eval_harness" /
                       "aggregates.json").read_text())[0]["num_samples"] == 12


def test_eval_harness_json_loader_as_jax(tmp_path):
    jharness.generate_example_benchmark(tmp_path / "b.json", n=5, seed=3)
    want = jharness.JsonBenchmarkLoader(str(tmp_path / "b.json"),
                                        jl.BenchmarkConfig(max_samples=4)).load()
    got = tharness.JsonBenchmarkLoader(str(tmp_path / "b.json"),
                                       tl.BenchmarkConfig(max_samples=4)).load()
    assert [sample_fields(s) for s in got] == [sample_fields(s) for s in want]


def test_eval_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """Every entry point of the slice defaults to ``--device cuda`` and
    raises on a host with no card unless the CPU is asked for."""
    import torch

    from gvl_tpu_torch.eval import run_phase1, run_phase2, run_phase3
    from gvl_tpu_torch.eval.model_inference import BenchmarkModelRunner
    from gvl_tpu_torch.eval.phase_runner import PhaseEvaluator
    from gvl_tpu_torch.scripts import (
        demo_projector_inference,
        extract_features,
        run_phase_evidence,
        smoke_test,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    example = str(tmp_path / "example.json")
    calls = [
        lambda: run_phase1.main(["--synthetic", "--max-samples", "2", "--configs", "gvp_light"]),
        lambda: run_phase2.main(["--synthetic", "--max-samples", "1"]),
        lambda: run_phase3.main(["--synthetic", "--max-samples", "1"]),
        lambda: tharness.main(["--generate-example", example, "--benchmark", example, "--mock"]),
        lambda: smoke_test.main([]),
        lambda: extract_features.main(["--video", "synthetic://x?duration=2"]),
        lambda: demo_projector_inference.main(["--embeddings", "x.npz"]),
        lambda: run_phase_evidence.main([]),
        lambda: BenchmarkModelRunner(),
        lambda: PhaseEvaluator("phase1", ["gvp_light"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "results").exists()
