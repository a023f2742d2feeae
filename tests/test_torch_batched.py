"""Batched and pipelined perception in gvl_tpu_torch
(``perception/batch.py`` ``run_batched_perception``,
``parallel/pipeline.py``, ``pipeline.run_pipelined_perception``,
``process_video(batched=True / pipelined=True)``) against the JAX
package's (``gvl_tpu.perception.batch``, ``gvl_tpu.parallel.pipeline``,
``scripts/realtime_inference.py``), on the trained weights of ``outputs/``
and small synthetic clips, on the CPU.

The port's mode equals JAX's same mode: timelines, transcripts and
knowledge bases equal, embeddings within 1e-4 of their largest magnitude,
confidences within 1e-4 (``test_torch_gvp_light.compare_processed``).

Against the sequential path, as JAX behaves on the CPU: events and
knowledge bases are equal in both modes.  The region embeddings are not:
batched and pipelined embed each segmented frame's own detections, the
sequential path the masks every tracked entity holds at that frame after
the whole clip is tracked, so the count at segmented frames differs (19
against 18 on this ``gvp_full`` clip) in both packages alike.  Batched and
pipelined give the same embeddings.  (The ``qa_lm`` arm embeds no region:
there every mode gives the sequential result, in both packages; the card
holds that in ``chip_smoke.py`` phase 14.)
"""

import threading
import time

import numpy as np
import pytest
import torch

from benchmarks.model_configs import get_model_config as jax_arm
from benchmarks.model_inference import FullPipelineRunner as JaxRunner
from gvl_tpu.parallel import pipeline as jpipeline
from gvl_tpu_torch import pipeline as tpipe
from gvl_tpu_torch.eval.model_configs import get_model_config as port_arm
from gvl_tpu_torch.eval.model_inference import FullPipelineRunner
from gvl_tpu_torch.parallel.pipeline import (
    PerceptionPipeline,
    PipelineStage,
    assign_stage_devices,
    build_perception_pipeline,
)

from scripts import realtime_inference as jri
from test_torch_gvp_light import _events, compare_processed

TOL = 1e-4
CLIPS = {"gvp_full": "synthetic://concept_demo_modes?duration=2&fps=8&entities=player,enemy,item"}
MODES = {"seq": {}, "batched": {"batched": True}, "pipelined": {"pipelined": True}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def processed():
    """Each arm's clip in each mode through both packages."""
    out = {}
    jri._LOOP_COMPONENT_CACHE.clear()
    tpipe._LOOP_COMPONENT_CACHE.clear()
    for arm, clip in CLIPS.items():
        for mode, kw in MODES.items():     # one loop per package, built once
            jcfg = JaxRunner(jax_arm(arm), use_cache=False).preset
            tcfg = FullPipelineRunner(port_arm(arm), use_cache=False, device="cpu").preset
            out[arm, mode] = (jri.process_video(clip, jcfg, use_cache=False, **kw),
                              tpipe.process_video(clip, tcfg, use_cache=False, device="cpu",
                                                  **kw))
    jri._LOOP_COMPONENT_CACHE.clear()
    tpipe._LOOP_COMPONENT_CACHE.clear()
    return out


@pytest.mark.parametrize("arm", list(CLIPS))
@pytest.mark.parametrize("mode", ["batched", "pipelined"])
def test_mode_equals_jax(processed, arm, mode):
    jax_pv, port_pv = processed[arm, mode]
    stage = f"{mode}_perception"
    assert stage in port_pv.timings and stage in jax_pv.timings
    assert "ocr_extraction" not in port_pv.timings      # OCR ran inside the mode
    compare_processed(jax_pv, port_pv, {"visual"})
    assert any(e.description.startswith("Temporal context") for e in port_pv.timeline.events)
    assert len(port_pv.siglip_embeddings) == 19


def _kb(pv):
    return pv.knowledge_base.export_for_llm(max_entities=15, max_relationships=20)


def _emb(pv):
    return [t for t, _ in pv.siglip_embeddings], (
        np.stack([e for _, e in pv.siglip_embeddings]) if pv.siglip_embeddings else None)


@pytest.mark.parametrize("arm", list(CLIPS))
@pytest.mark.parametrize("mode", ["batched", "pipelined"])
def test_mode_against_sequential_as_jax(processed, arm, mode):
    """Events and KB equal to the sequential path's in both packages; the
    embeddings' count apart in both (see the module docstring)."""
    for k in (0, 1):                      # JAX, then the port
        seq, got = processed[arm, "seq"][k], processed[arm, mode][k]
        assert _events(got.timeline) == _events(seq.timeline)
        assert _kb(got) == _kb(seq)
        assert (got.timeline.build_structured_transcript()
                == seq.timeline.build_structured_transcript())
    jax_same = _emb(processed[arm, mode][0])[0] == _emb(processed[arm, "seq"][0])[0]
    port_same = _emb(processed[arm, mode][1])[0] == _emb(processed[arm, "seq"][1])[0]
    assert port_same == jax_same is False
    assert (len(processed[arm, "seq"][1].siglip_embeddings),
            len(processed[arm, mode][1].siglip_embeddings)) == (18, 19)


def test_batched_and_pipelined_embed_alike(processed):
    ts_b, emb_b = _emb(processed["gvp_full", "batched"][1])
    ts_p, emb_p = _emb(processed["gvp_full", "pipelined"][1])
    assert ts_b == ts_p
    np.testing.assert_allclose(emb_p, emb_b, atol=TOL * np.abs(emb_b).max(), rtol=0)


def test_batched_chunks_and_reuse():
    """Chunks smaller than the clip, with the segmentation submitted one
    chunk ahead, and pre-built models give the one-chunk result (every
    fourth frame segmented here: chunks of 5 hold 2, 1 and 1 of them)."""
    from gvl_tpu_torch.fusion import KnowledgeBaseBuilder, TimelineIndexer
    from gvl_tpu_torch.io.ingest import resolve_video_source
    from gvl_tpu_torch.perception.batch import build_perception_stack, run_batched_perception

    cfg = FullPipelineRunner(port_arm("gvp_full"), use_cache=False, device="cpu").preset
    cfg.perception.sam3_fps = 2.0
    cfg.perception.use_ocr = False
    frames = resolve_video_source(CLIPS["gvp_full"], fps=cfg.inference.fps)
    stack = build_perception_stack(cfg, device="cpu")
    submitted = []
    backend = stack[0].backend
    real_submit = backend.submit

    def submit(frames_, concepts):
        submitted.append(len(frames_))
        return real_submit(frames_, concepts)

    backend.submit = submit
    runs = []
    for chunk in (5, 32):
        timeline, kb = TimelineIndexer(), KnowledgeBaseBuilder()
        embs = run_batched_perception(frames, cfg, timeline, kb, chunk=chunk,
                                      segmenter=stack[0], encoder=stack[1], ocr=stack[2],
                                      device="cpu")
        stack[0].reset()
        runs.append((embs, _events(timeline), kb.export_for_llm()))
    assert submitted == [2, 1, 1, 4]
    (small, small_events, small_kb), (whole, whole_events, whole_kb) = runs
    assert [t for t, _ in small] == [t for t, _ in whole]
    want = np.stack([e for _, e in whole])
    np.testing.assert_allclose(np.stack([e for _, e in small]), want,
                               atol=TOL * np.abs(want).max(), rtol=0)
    assert small_events == whole_events and small_kb == whole_kb


# ------------------------------------------------------------ the pipeline

def test_results_in_order_and_counted():
    """Ten items through three stages come out in order, transformed as
    JAX's pipeline transforms them."""
    fns = [lambda x: x + 1, lambda x: x * 2, lambda x: x - 3]
    got = list(PerceptionPipeline([PipelineStage(n, f) for n, f in zip("abc", fns)],
                                  queue_depth=2).run(range(10)))
    want = list(jpipeline.PerceptionPipeline(
        [jpipeline.PipelineStage(n, f) for n, f in zip("abc", fns)], queue_depth=2).run(range(10)))
    assert got == want == [(i + 1) * 2 - 3 for i in range(10)]
    pipeline = build_perception_pipeline({"a": fns[0], "b": fns[1]}, devices=[])
    assert list(pipeline.run([1, 2])) == [4, 6]
    assert pipeline.stage_counts == {"a": 2, "b": 2}


def test_stages_overlap():
    """With a sleep in each stage the stages run at once: the wall is under
    the sum of the stages."""
    active = {"now": 0, "max": 0}
    lock = threading.Lock()

    def fn(x):
        with lock:
            active["now"] += 1
            active["max"] = max(active["max"], active["now"])
        time.sleep(0.02)
        with lock:
            active["now"] -= 1
        return x

    start = time.perf_counter()
    list(PerceptionPipeline([PipelineStage(f"s{i}", fn) for i in range(3)]).run(range(12)))
    assert active["max"] >= 2
    assert time.perf_counter() - start < 12 * 3 * 0.02


def test_error_propagates():
    def boom(x):
        if x == 3:
            raise ValueError("bad frame")
        return x

    seen = []
    pipeline = PerceptionPipeline([PipelineStage("s", boom),
                                   PipelineStage("t", lambda x: seen.append(x) or x)])
    got = []
    with pytest.raises(ValueError, match="bad frame"):
        for item in pipeline.run(range(6)):
            got.append(item)
    assert got == [0, 1, 2] and 3 not in seen


def test_back_pressure_bounds_the_queues():
    """A slow last stage holds the feeder back: no more than the queues'
    depth plus one item per stage runs ahead of the consumer."""
    fed = []
    depth = 2

    def items():
        for i in range(30):
            fed.append(i)
            yield i

    def slow(x):
        time.sleep(0.01)
        return x

    pipeline = PerceptionPipeline([PipelineStage("fast", lambda x: x),
                                   PipelineStage("slow", slow)], queue_depth=depth)
    ahead = 0
    for i, item in enumerate(pipeline.run(items())):
        assert item == i
        ahead = max(ahead, len(fed) - i)
    assert ahead <= 3 * depth + 2 + 1
    assert len(fed) == 30


def test_stage_devices_and_inference_mode():
    """Round-robin devices; each worker enters inference mode (per thread);
    a CPU stage gets no stream."""
    import torch

    cpu = torch.device("cpu")
    assert assign_stage_devices(3, [cpu]) == [cpu, cpu, cpu]
    assert assign_stage_devices(2, []) == [None, None]
    if not torch.cuda.is_available():
        assert assign_stage_devices(2) == [None, None]
    flags = []
    list(PerceptionPipeline([PipelineStage("s", lambda x: flags.append(
        torch.is_inference_mode_enabled()) or x, cpu)]).run(range(3)))
    assert flags == [True, True, True]
    assert not torch.is_inference_mode_enabled()
