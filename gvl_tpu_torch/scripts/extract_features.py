"""Offline feature extraction: video → training-ready artifacts (the port's
copy of ``scripts/extract_features.py``, on ``--device``).

    python -m gvl_tpu_torch.scripts.extract_features --video <clip> [--device cpu]

The 8-step batch pipeline (the stages of :mod:`gvl_tpu_torch.pipeline`)
producing, for each video:

- ``{video}_features.json``   — detections, OCR, transcription, timeline
- ``{video}_embeddings.npz``  — siglip / videomae / wav2vec2 arrays
- ``{video}_embeddings.pt``   — the same tensors in the ``.pt`` layout
  (always, unless ``--no-torch``: torch always imports here)
- ``{video}_context.txt``     — GPT-ready structured context

plus keyword-pattern causal inference into the knowledge base (ATTACK /
EFFECT / VICTORY / SKILL patterns within a 5 s window).
"""

from __future__ import annotations

import argparse
import json
import logging
import re
from pathlib import Path

import numpy as np
import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.config import load_preset
from gvl_tpu_torch.fusion import (
    KnowledgeBaseBuilder,
    RelationType,
    TimelineIndexer,
)
from gvl_tpu_torch.io import extract_frames
from gvl_tpu_torch.pipeline import (  # shared pipeline stages
    DEFAULT_CONCEPTS,
    extract_siglip_embeddings,
    extract_videomae_embeddings,
    run_audio_analysis,
    run_hico,
    run_ocr_extraction,
    run_sam_detection,
)

logger = logging.getLogger("extract_features")

# keyword-pattern causal rules: (cause regex, effect regex, relation)
CAUSAL_PATTERNS = [
    (r"attack|hit|strike|shot", r"damage|-\d+|hp", RelationType.ATTACKS),
    (r"explosion|blast|fire", r"destroy|dead|defeat", RelationType.DESTROYS),
    (r"heal|potion|restore", r"\+\d+|hp|health", RelationType.HEALS),
    (r"spawn|appear", r"detected", RelationType.SPAWNS),
]
CAUSAL_WINDOW_SEC = 5.0


def build_knowledge_base_with_causality(
    timeline: TimelineIndexer, kb: KnowledgeBaseBuilder
) -> int:
    """Scan event pairs within the window for keyword-causal links."""
    events = timeline.events
    added = 0
    for i, cause in enumerate(events):
        for effect in events[i + 1:]:
            if effect.timestamp - cause.timestamp > CAUSAL_WINDOW_SEC:
                break
            for cause_re, effect_re, relation in CAUSAL_PATTERNS:
                if (re.search(cause_re, cause.description.lower())
                        and re.search(effect_re, effect.description.lower())):
                    source = cause.entity_id or f"event_{i}"
                    target = effect.entity_id or "environment"
                    if source not in kb.entities:
                        kb.register_entity(source, cause.description[:40],
                                           timestamp=cause.timestamp)
                    if target not in kb.entities:
                        kb.register_entity(target, effect.description[:40],
                                           timestamp=effect.timestamp)
                    kb.add_relationship(
                        source, target, relation, cause.timestamp,
                        confidence=0.6,
                        metadata={"inferred": "keyword_causality"},
                    )
                    added += 1
    return added


def format_for_gpt(timeline: TimelineIndexer, kb: KnowledgeBaseBuilder,
                   video_path: str) -> str:
    """Human/LLM-readable context document."""
    stats = timeline.get_statistics()
    lines = [
        f"# Video Context: {Path(video_path).name}",
        "",
        f"Duration: {stats['duration']:.0f}s | Events: {stats['total_events']}"
        f" | Entities: {stats['unique_entities']}",
        "",
        "## Timeline",
        timeline.build_structured_transcript(max_events=200),
        "",
        kb.export_for_llm(max_entities=30, max_relationships=50),
    ]
    return "\n".join(lines)


def extract_video(video_path: str, output_dir: Path, config,
                  concepts: list[str],
                  save_torch: bool = True,
                  device: str | torch.device = "cuda") -> dict:
    """``save_torch`` writes the ``.pt`` beside the ``.npz``, as the JAX
    script does whenever torch imports: here, by default."""
    device = resolve_device(device)
    timeline = TimelineIndexer()
    kb = KnowledgeBaseBuilder()

    frames = extract_frames(video_path, fps=config.inference.fps)
    logger.info("%s: %d frames @ %.1f fps", video_path, len(frames),
                config.inference.fps)

    segmenter = run_sam_detection(frames, config, timeline, kb, concepts,
                                  device=device)
    siglip = extract_siglip_embeddings(frames, segmenter, config, device=device)
    videomae = extract_videomae_embeddings(frames, config, device=device)
    audio_result, wav2vec = run_audio_analysis(video_path, timeline, config,
                                               device=device)
    ocr_frames = run_ocr_extraction(frames, timeline, config, device=device)
    hico_tokens = run_hico(frames, timeline, config, device=device)
    timeline.merge_and_dedupe()
    causal_links = build_knowledge_base_with_causality(timeline, kb)

    stem = Path(
        str(video_path).replace("synthetic://", "synthetic_").split("?")[0]
    ).stem
    output_dir.mkdir(parents=True, exist_ok=True)

    # features.json
    features_doc = {
        "video": str(video_path),
        "num_frames": len(frames),
        "fps": config.inference.fps,
        "entities": [
            {
                "entity_id": e.entity_id,
                "concept": e.concept_label,
                "state": e.state.value,
                "first_seen_frame": e.first_seen_frame,
                "last_seen_frame": e.last_seen_frame,
            }
            for e in segmenter.get_all_entities()
        ],
        "ocr": [
            {"timestamp": f.timestamp,
             "texts": [d.text for d in f.detections]}
            for f in ocr_frames if f.detections
        ],
        "transcription": [
            {"start": s.start_time, "end": s.end_time, "text": s.text}
            for s in audio_result.transcriptions
        ],
        "timeline_events": len(timeline.events),
        "causal_links": causal_links,
    }
    (output_dir / f"{stem}_features.json").write_text(
        json.dumps(features_doc, indent=2))

    # embeddings
    emb = {
        "siglip_ts": np.asarray([t for t, _ in siglip]),
        "siglip": (np.stack([e for _, e in siglip])
                   if siglip else np.zeros((0, 1152), np.float32)),
        "videomae_ts": np.asarray([t for t, _ in videomae]),
        "videomae": (np.stack([e for _, e in videomae])
                     if videomae else np.zeros((0, 768), np.float32)),
        "wav2vec2_ts": np.asarray([t for t, _ in wav2vec]),
        "wav2vec2": (np.stack([e for _, e in wav2vec])
                     if wav2vec else np.zeros((0, 1024), np.float32)),
        "hico": (np.stack([t.embedding for t in hico_tokens])
                 if hico_tokens else np.zeros((0, 1408), np.float32)),
    }
    np.savez_compressed(output_dir / f"{stem}_embeddings.npz", **emb)
    if save_torch:
        torch.save(
            {k: torch.from_numpy(np.asarray(v)) for k, v in emb.items()},
            output_dir / f"{stem}_embeddings.pt",
        )

    (output_dir / f"{stem}_context.txt").write_text(
        format_for_gpt(timeline, kb, video_path))
    logger.info("wrote %s_{features.json,embeddings.npz,context.txt}", stem)
    return features_doc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--video", required=True, nargs="+")
    parser.add_argument("--output-dir", default="data/features")
    parser.add_argument("--preset", default="light",
                        choices=["light", "standard", "full"])
    parser.add_argument("--fps", type=float, default=None)
    parser.add_argument("--concepts", nargs="*", default=DEFAULT_CONCEPTS)
    parser.add_argument("--torch", dest="torch", action="store_true",
                        default=True,
                        help="write the .pt embeddings (the default)")
    parser.add_argument("--no-torch", dest="torch", action="store_false",
                        help="skip the .pt embeddings file")
    parser.add_argument("--skip-hico", action="store_true", default=False)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "PyTorch path)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    config = load_preset(args.preset)
    if args.fps is not None:
        config.inference.fps = args.fps
    if args.skip_hico:
        config.temporal.use_hico = False

    for video in args.video:
        extract_video(video, Path(args.output_dir), config, args.concepts,
                      save_torch=args.torch, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
