"""Smoke test: 7 fast checks of the port's stack on ``--device`` (the port's
copy of ``scripts/smoke_test.py``).

    python -m gvl_tpu_torch.scripts.smoke_test [--device cpu]

Each check runs the port's counterpart of the JAX script's check; the
models, projectors and the reasoning loop are built on ``--device``
(default ``cuda``: raises without a card).  Runs on the CPU in well under a
minute; exits non-zero on any failure.
"""

from __future__ import annotations

import argparse
import traceback

import numpy as np

from gvl_tpu_torch import resolve_device


def check_imports(device):
    """1. every subpackage imports"""
    import gvl_tpu_torch.agent
    import gvl_tpu_torch.audio
    import gvl_tpu_torch.cache
    import gvl_tpu_torch.config
    import gvl_tpu_torch.eval
    import gvl_tpu_torch.fusion
    import gvl_tpu_torch.io
    import gvl_tpu_torch.models
    import gvl_tpu_torch.nn
    import gvl_tpu_torch.ops
    import gvl_tpu_torch.parallel
    import gvl_tpu_torch.perception
    import gvl_tpu_torch.temporal  # noqa: F401


def check_presets(device):
    """2. all presets load with sane HBM estimates"""
    from gvl_tpu_torch.config import load_preset

    for name in ("light", "standard", "full"):
        cfg = load_preset(name)
        assert cfg.estimated_hbm_gb > 0
        assert cfg.get_hbm_breakdown()


def check_timeline_kb(device):
    """3. timeline + knowledge base round-trip"""
    from gvl_tpu_torch.fusion import KnowledgeBaseBuilder, ModalityType, TimelineIndexer

    idx = TimelineIndexer()
    idx.add_event(83.0, ModalityType.VISUAL, "boss appears", entity_id="b1")
    idx.add_event(84.0, ModalityType.AUDIO, "roar")
    transcript = idx.build_structured_transcript()
    assert "[01:23] boss appears" in transcript
    kb = KnowledgeBaseBuilder()
    kb.register_entity("b1", "boss")
    assert "b1" in kb.export_for_llm()


def check_perception_fakes(device):
    """4. segmentation/OCR/semantic fakes produce valid outputs"""
    from gvl_tpu_torch.perception.ocr import OCRConfig, OCRPipeline
    from gvl_tpu_torch.perception.segmenter import SAMConceptSegmenter
    from gvl_tpu_torch.perception.semantic import SigLIPSemanticEncoder

    frame = np.random.default_rng(0).integers(
        0, 255, (120, 160, 3), dtype=np.uint8)
    entities = SAMConceptSegmenter().segment_with_prompts(frame, 0, ["boss"])
    assert entities and entities[0].entity_id == "boss_000"
    result = OCRPipeline(OCRConfig(backend="fake"), device=device).extract_text_from_frame(
        frame, 0, 0.0)
    assert result.detections
    emb = SigLIPSemanticEncoder().encode_image(frame)
    assert emb.shape == (1152,)


def check_projector_and_retrieval(device):
    """5. projector shapes + hybrid retrieval"""
    from gvl_tpu_torch.agent import ReasoningCoreConfig, TimelineRetriever
    from gvl_tpu_torch.fusion import ModalityType, TimelineIndexer
    from gvl_tpu_torch.models.projector import ProjectorBank

    bank = ProjectorBank(device=device).init()
    out = bank.project_region(np.zeros((2, 1152), np.float32))
    assert out.shape == (2, 4096)
    idx = TimelineIndexer()
    idx.add_event(100.0, ModalityType.VISUAL, "dragon fight")
    retriever = TimelineRetriever(ReasoningCoreConfig(), device=device)
    retriever.index_timeline(idx)
    assert retriever.hybrid_retrieve("dragon", idx)


def check_reasoning_loop(device):
    """6. end-to-end fake-backend reasoning"""
    from gvl_tpu_torch.agent import PerceptionReasoningLoop
    from gvl_tpu_torch.fusion import ModalityType, TimelineIndexer

    idx = TimelineIndexer()
    idx.add_event(12.0, ModalityType.VISUAL, "boss appears")
    loop = PerceptionReasoningLoop(timeline_indexer=idx, device=device)
    loop.start()
    response = loop.process_frame(
        timestamp=12.0,
        visual_detections=[{"label": "boss", "confidence": 0.95}],
    )
    assert response and "**Answer:**" in response


def check_synthetic_video(device):
    """7. synthetic video source + frame extraction"""
    from gvl_tpu_torch.io import extract_frames

    frames = extract_frames("synthetic://smoke?duration=4&fps=4", fps=2.0)
    assert len(frames) == 8
    assert frames[0][1].shape == (240, 320, 3)


CHECKS = [
    check_imports,
    check_presets,
    check_timeline_kb,
    check_perception_fakes,
    check_projector_and_retrieval,
    check_reasoning_loop,
    check_synthetic_video,
]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "PyTorch path)")
    device = resolve_device(parser.parse_args(argv).device)
    failed = 0
    for i, check in enumerate(CHECKS, 1):
        label = (check.__doc__ or check.__name__).strip()
        try:
            check(device)
            print(f"  [{i}/7] PASS  {label}")
        except Exception:
            failed += 1
            print(f"  [{i}/7] FAIL  {label}")
            traceback.print_exc()
    print("\nSMOKE TEST:", "PASS" if not failed else f"{failed} FAILURES")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
