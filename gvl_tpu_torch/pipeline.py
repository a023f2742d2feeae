"""Gameplay-video QA end to end: perception -> external memory -> answers.

The port's copy of the host stages of ``scripts/realtime_inference.py``:
a clip (``synthetic://...``, ``.y4m``, or a codec file through ffmpeg) is
decoded (:func:`gvl_tpu_torch.io.ingest.resolve_video_source`), segmented
and tracked (or, without the segmenter, labelled zero-shot by the
mini-SigLIP on motion proposals), embedded by region or whole frame
(SigLIP), cut into clips for the VideoMAE encoder (whose trained heads
write motion events), its audio analysed (events, gated byte ASR, chunk
embeddings), its frames read by OCR and compressed by HiCo; the
detections fill a :class:`~gvl_tpu_torch.fusion.timeline.TimelineIndexer`
and a :class:`~gvl_tpu_torch.fusion.knowledge_base.KnowledgeBaseBuilder`,
and a :class:`~gvl_tpu_torch.agent.loop.PerceptionReasoningLoop` answers
questions over them (:func:`answer_query`, :func:`answer_query_streaming`).

Every model runs on ``device`` (``"cuda"`` by default; raises without a
card unless ``device="cpu"``).  ``batched=True`` takes the chunked
perception of :func:`gvl_tpu_torch.perception.batch.run_batched_perception`
and ``pipelined=True`` the stage-parallel one
(:func:`run_pipelined_perception`), as the JAX script does.  As in the JAX
script, ``process_video`` decodes at ``config.inference.fps`` with no frame
cap.  The command line is :mod:`gvl_tpu_torch.scripts.realtime_inference`.
"""

from __future__ import annotations

import json
import logging
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gvl_tpu_torch.agent import PerceptionReasoningLoop, ReasoningCoreConfig
from gvl_tpu_torch.cache import FeatureCache
from gvl_tpu_torch.config import SystemConfig, load_preset
from gvl_tpu_torch.fusion import (
    EntityCategory,
    EventPriority,
    KnowledgeBaseBuilder,
    ModalityType,
    TimelineIndexer,
)
from gvl_tpu_torch.utils.checkpoints import resolve_repo_path
from gvl_tpu_torch.utils.profiler import StageTimer

logger = logging.getLogger(__name__)

DEFAULT_CONCEPTS = ["player", "enemy", "boss", "item"]


@dataclass
class ProcessedVideo:
    """Everything extracted from one video + the live reasoning loop."""

    video_path: str
    timestamps: list[float] = field(default_factory=list)
    timeline: TimelineIndexer = field(default_factory=TimelineIndexer)
    knowledge_base: KnowledgeBaseBuilder = field(
        default_factory=KnowledgeBaseBuilder)
    siglip_embeddings: list[tuple[float, np.ndarray]] = field(
        default_factory=list)
    videomae_embeddings: list[tuple[float, np.ndarray]] = field(
        default_factory=list)
    audio_embeddings: list[tuple[float, np.ndarray]] = field(
        default_factory=list)
    loop: Optional[PerceptionReasoningLoop] = None
    timings: dict = field(default_factory=dict)


def run_sam_detection(frames, config: SystemConfig, timeline, kb,
                      concepts=DEFAULT_CONCEPTS, device="cuda"):
    """Segment+track at the (lower) segmenter rate; feed timeline + KB."""
    from gvl_tpu_torch.perception.batch import build_segmenter

    sam_step = max(1, int(round(config.inference.fps
                                / max(config.perception.sam3_fps, 1e-6))))
    segmenter = build_segmenter(config, device=device)
    sampled = [(i, ts, frame) for i, (ts, frame) in enumerate(frames)
               if i % sam_step == 0]
    if not sampled:
        return segmenter
    batch = segmenter.segment_batch(
        [f for _, _, f in sampled], [i for i, _, _ in sampled], concepts
    )
    for (idx, ts, _), entities in zip(sampled, batch):
        timeline.add_from_sam_entities(entities, idx, ts)
        kb.update_from_tracking(entities, idx, ts)
    return segmenter


def run_audio_analysis(video_path: str, timeline, config: SystemConfig,
                       device="cuda"):
    """Sibling .wav (or silence) → ASR + events into the timeline; the
    backends come from the preset ladder
    (:func:`gvl_tpu_torch.audio.processor.build_audio_stack`)."""
    from gvl_tpu_torch.audio.processor import build_audio_stack

    proc, embedder = build_audio_stack(config.audio, device=device)
    if str(video_path).startswith("synthetic://"):
        from gvl_tpu_torch.io.video import SyntheticVideo

        synth = SyntheticVideo.from_url(str(video_path))
        if synth.with_audio:   # procedural track with known truth
            audio, rate = synth.audio()
        else:
            audio, rate = np.zeros(16000, np.float32), 16000
    elif (wav_path := Path(video_path).with_suffix(".wav")).exists():
        audio, rate = proc.preprocessor.load_audio(wav_path)
    else:
        audio, rate = proc.preprocessor.extract_from_video(video_path)
    result = proc.analyze_audio(audio, rate)
    timeline.add_from_audio_result(result)
    # wav2vec2-style chunk embeddings (10 s chunks)
    embeddings = [
        (start, embedder(chunk, rate))
        for chunk, start, _ in proc.preprocessor.chunk_audio(
            audio, rate, chunk_duration=10.0, overlap=0.0)
    ]
    return result, embeddings


def run_ocr_extraction(frames, timeline, config: SystemConfig, device="cuda"):
    """OCR each frame; conf>=0.7 & len>=3 filter before timeline entry."""
    from gvl_tpu_torch.perception.ocr import create_ocr_pipeline

    ocr = create_ocr_pipeline(config.perception.ocr_backend, device=device)
    ocr_frames = []
    for idx, (ts, frame) in enumerate(frames):
        result = ocr.extract_text_from_frame(frame, idx, ts)
        ocr_frames.append(result)
        for det in result.detections:
            if det.confidence < 0.7 or len(det.text) < 3:
                continue
            important = det.category in ("damage", "health")
            timeline.add_event(
                ts, ModalityType.OCR, det.text,
                priority=EventPriority.MEDIUM if important else EventPriority.LOW,
                confidence=det.confidence,
                metadata={"category": det.category, "bbox": det.bbox},
            )
    return ocr_frames


def extract_siglip_embeddings(frames, segmenter, config: SystemConfig, device="cuda"):
    """Per-frame region (or whole-frame) semantic embeddings through the
    preset's encoder (:func:`gvl_tpu_torch.perception.batch.build_siglip_encoder`)."""
    from gvl_tpu_torch.perception.batch import build_siglip_encoder

    encoder = build_siglip_encoder(config, device=device)
    out = []
    for idx, (ts, frame) in enumerate(frames):
        masks = []
        for entity in segmenter.get_all_entities():
            mask = entity.get_mask_at_frame(idx)
            if mask is not None:
                masks.append((entity.entity_id, mask.mask))
        if masks:
            for emb in encoder.encode_masked_regions(frame, masks):
                out.append((ts, emb.embedding))
        else:
            out.append((ts, encoder.encode_image(frame)))
    return out


def extract_videomae_embeddings(frames, config: SystemConfig, timeline=None, device="cuda"):
    """16-frame clips, stride 8 → clip embeddings through the preset ladder:
    the self-trained mini tower (which also writes motion events into
    ``timeline``) or the hash fake."""
    from gvl_tpu_torch.temporal.clip_encoder import (
        build_clip_encoder,
        extract_clip_embeddings,
    )

    return extract_clip_embeddings(frames, build_clip_encoder(config, device=device),
                                   timeline=timeline)


def run_hico(frames, timeline, config: SystemConfig, device="cuda"):
    """HiCo temporal compression of the clip (CLIP level), its tokens into
    the timeline; the compressor reads ``outputs/hico_params.npz`` as the
    JAX script's does (:class:`~gvl_tpu_torch.temporal.hico.
    TemporalCompressionModule`).

    ROADMAP C8, settled as C7 was: where that file resolves but is not of
    the module's shapes (or cannot be read) this rung raises, where JAX
    compresses with a random initialisation; without the file it keeps
    JAX's random initialisation."""
    from gvl_tpu_torch.temporal.hico import TemporalCompressionModule

    if not config.temporal.use_hico or len(frames) < 2:
        return []
    module = TemporalCompressionModule(device=device, strict=True)
    tokens = module.segment_and_compress(
        np.stack([f for _, f in frames]), fps=config.inference.fps)
    timeline.add_from_hico_tokens(tokens)
    return tokens


def run_pipelined_perception(frames, config: SystemConfig, timeline, kb,
                             concepts=DEFAULT_CONCEPTS, device="cuda"):
    """Frame-major perception through the stage-parallel pipeline
    (:mod:`gvl_tpu_torch.parallel.pipeline`): segment and track → region
    semantics → OCR, each in its own worker (on a card, its own stream on
    ``device``) with bounded queues, so frame i+1 segments while frame i
    is encoded.  Returns the per-timestamp semantic embeddings."""
    from gvl_tpu_torch.parallel.pipeline import PerceptionPipeline, PipelineStage
    from gvl_tpu_torch.perception.batch import build_perception_stack

    segmenter, encoder, ocr = build_perception_stack(config, device=device)
    sam_step = max(1, int(round(config.inference.fps
                                / max(config.perception.sam3_fps, 1e-6))))

    def stage_segment(item):
        idx, ts, frame = item
        entities = []
        if config.perception.use_sam and idx % sam_step == 0:
            entities = segmenter.segment_with_prompts(frame, idx, concepts)
        return idx, ts, frame, entities

    def stage_semantic(item):
        idx, ts, frame, entities = item
        embeddings = []
        if config.perception.use_siglip:
            masks = [(e.entity_id, e.frame_masks[idx].mask)
                     for e in entities if idx in e.frame_masks]
            if masks:
                embeddings = [(ts, emb.embedding)
                              for emb in encoder.encode_masked_regions(frame, masks)]
            else:
                embeddings = [(ts, encoder.encode_image(frame))]
        return idx, ts, frame, entities, embeddings

    def stage_ocr(item):
        idx, ts, frame, entities, embeddings = item
        ocr_result = (ocr.extract_text_from_frame(frame, idx, ts)
                      if config.perception.use_ocr else None)
        return idx, ts, entities, embeddings, ocr_result

    stage_device = torch.device(device)
    pipeline = PerceptionPipeline([
        PipelineStage("segment", stage_segment, stage_device),
        PipelineStage("semantic", stage_semantic, stage_device),
        PipelineStage("ocr", stage_ocr, stage_device),
    ])

    siglip_embeddings = []
    for idx, ts, entities, embeddings, ocr_result in pipeline.run(
            [(i, ts, frame) for i, (ts, frame) in enumerate(frames)]):
        if entities:
            timeline.add_from_sam_entities(entities, idx, ts)
            kb.update_from_tracking(entities, idx, ts)
        siglip_embeddings.extend(embeddings)
        if ocr_result is not None:
            for det in ocr_result.detections:
                if det.confidence < 0.7 or len(det.text) < 3:
                    continue
                important = det.category in ("damage", "health")
                timeline.add_event(
                    ts, ModalityType.OCR, det.text,
                    priority=(EventPriority.MEDIUM if important else EventPriority.LOW),
                    confidence=det.confidence,
                    metadata={"category": det.category, "bbox": det.bbox},
                )
    return siglip_embeddings


def process_video(
    video_path: str,
    config: Optional[SystemConfig] = None,
    use_cache: bool = True,
    concepts: list[str] = DEFAULT_CONCEPTS,
    pipelined: bool = False,
    batched: bool = False,
    device: str | torch.device = "cuda",
    embedding_model: Optional[str] = None,
) -> ProcessedVideo:
    """Run (or reload) the full perception stack and build the loop.

    ``embedding_model`` sets the retriever's embedder
    (``ReasoningCoreConfig.embedding_model``: a trained retriever
    directory, "hashing" or "auto"); None keeps its default, "auto"."""
    from gvl_tpu_torch import resolve_device
    from gvl_tpu_torch.io.ingest import resolve_video_source

    device = resolve_device(device)
    config = config or load_preset("light")
    timer = StageTimer()
    cache = (FeatureCache(config.inference.cache_dir)
             if use_cache and config.inference.use_feature_cache else None)
    result = ProcessedVideo(video_path=video_path)
    timeline, kb = result.timeline, result.knowledge_base

    cached = cache.load_features(video_path) if cache is not None else None
    if cached is not None:
        logger.info("cache hit for %s", video_path)
        _restore_from_cache(result, cached)
    else:
        with timer.stage("frame_extraction"):
            # YouTube URLs download first (yt-dlp), codec files go
            # through the ffmpeg→y4m ladder, synthetic:// and .y4m
            # are read directly
            frames = resolve_video_source(
                video_path, fps=config.inference.fps)
        result.timestamps = [t for t, _ in frames]

        if batched:
            # throughput-oriented: chunked frames x concepts segmentation,
            # shared region and OCR batches
            from gvl_tpu_torch.perception.batch import run_batched_perception

            with timer.stage("batched_perception"):
                result.siglip_embeddings = run_batched_perception(
                    frames, config, timeline, kb, concepts, device=device)
        elif pipelined:
            with timer.stage("pipelined_perception"):
                result.siglip_embeddings = run_pipelined_perception(
                    frames, config, timeline, kb, concepts, device=device)
        else:
            if config.perception.use_sam:
                with timer.stage("sam_detection"):
                    segmenter = run_sam_detection(frames, config, timeline, kb, concepts,
                                                  device=device)
            else:
                from gvl_tpu_torch.perception.batch import build_segmenter

                segmenter = build_segmenter(config, device=device)
                if config.perception.use_siglip:
                    # segmenter-free grounding: zero-shot mini-SigLIP labels
                    # of motion proposals → VISUAL events
                    from gvl_tpu_torch.perception.frame_labeler import emit_zero_shot_labels

                    with timer.stage("zero_shot_labels"):
                        emit_zero_shot_labels(frames, config, timeline, concepts=concepts,
                                              device=device)

            if config.perception.use_siglip:
                with timer.stage("siglip_embeddings"):
                    result.siglip_embeddings = extract_siglip_embeddings(
                        frames, segmenter, config, device=device)

        if config.perception.use_videomae:
            with timer.stage("videomae_embeddings"):
                result.videomae_embeddings = extract_videomae_embeddings(
                    frames, config, timeline=timeline, device=device)

        if config.audio.use_audio:
            with timer.stage("audio_analysis"):
                _, result.audio_embeddings = run_audio_analysis(
                    video_path, timeline, config, device=device)

        if config.perception.use_ocr and not (pipelined or batched):
            with timer.stage("ocr_extraction"):
                run_ocr_extraction(frames, timeline, config, device=device)

        with timer.stage("temporal_compression"):
            run_hico(frames, timeline, config, device=device)

        with timer.stage("timeline_indexing"):
            timeline.merge_and_dedupe()

        if cache is not None:
            with timer.stage("cache_save"):
                cache.save_features(video_path, _to_cache_dict(result))

    _finalize_processed(result, config, timer, device=device,
                        embedding_model=embedding_model)
    logger.info("%s\n%s", video_path, timer.report())
    return result


def processed_from_features(video_path: str, config: SystemConfig,
                            features: dict, device="cuda",
                            embedding_model: Optional[str] = None) -> ProcessedVideo:
    """Build a live :class:`ProcessedVideo` (incl. the reasoning loop)
    from a previously persisted feature dict (the ``_to_cache_dict``
    layout) WITHOUT running any perception (``embedding_model`` as
    :func:`process_video` takes it).

    ROADMAP C13: JAX's rebuild keeps only the knowledge base's entity
    names (``_restore_from_cache``) and clears the reasoning core's
    conversation, so a process that answers a benchmark from a perception
    cache prompts otherwise than the process that wrote it (whose answers
    follow one another in one conversation, the videos having been built
    before the first answer).  Here the whole knowledge base is rebuilt
    from the stored schema dict and the conversation is kept, so a cold
    process answers as the warm one did."""
    from gvl_tpu_torch.fusion.schema import kb_from_schema_dict

    timer = StageTimer()
    result = ProcessedVideo(video_path=video_path)
    with timer.stage("cache_restore"):
        _restore_from_cache(result, features)
        result.knowledge_base = kb_from_schema_dict(features.get("knowledge_base") or {})
    _finalize_processed(result, config, timer, device=device,
                        embedding_model=embedding_model, clear_conversation=False)
    return result


def _config_width(checkpoint: Optional[str], name: str, section: str) -> Optional[int]:
    """The hidden width a trained checkpoint directory records, if it is one."""
    path = Path(checkpoint) / name if checkpoint else None
    if path is None or not path.exists():
        return None
    return int(json.loads(path.read_text())[section]["hidden_size"])


def _finalize_processed(result: ProcessedVideo, config: SystemConfig,
                        timer: StageTimer, device="cuda",
                        embedding_model: Optional[str] = None,
                        clear_conversation: bool = True) -> None:
    """Shared tail of process_video: projector-dim resolution + loop (the
    shared reasoning core's conversation cleared for the new video, unless
    ``clear_conversation`` is off)."""
    timeline, kb = result.timeline, result.knowledge_base
    reasoning_config = ReasoningCoreConfig(
        max_new_tokens=config.reasoning.max_new_tokens,
        trigger_concepts=config.inference.trigger_concepts,
        trigger_confidence_threshold=
            config.inference.trigger_confidence_threshold,
    )
    if embedding_model is not None:
        reasoning_config.embedding_model = embedding_model
    # a trained mini tower emits its own embedding width — the projector
    # heads must match the encoder actually in use (as in JAX)
    width = _config_width(resolve_repo_path(getattr(
        config.perception, "siglip_checkpoint", None)), "minisiglip_config.json", "vision")
    if width:
        reasoning_config.siglip_dim = width
    width = _config_width(resolve_repo_path(getattr(
        config.perception, "videomae_checkpoint", None)), "videomae_config.json", "model")
    if width:
        reasoning_config.videomae_dim = width
    # the data wins over the ladder: a cache hit may carry embeddings
    # from a different tower than the currently-resolved checkpoints
    if result.videomae_embeddings:
        reasoning_config.videomae_dim = int(
            result.videomae_embeddings[0][1].shape[-1])
    if result.siglip_embeddings:
        reasoning_config.siglip_dim = int(
            result.siglip_embeddings[0][1].shape[-1])
    if result.audio_embeddings:
        reasoning_config.audiomae_dim = int(
            result.audio_embeddings[0][1].shape[-1])
    with timer.stage("loop_init"):
        core, projectors = _loop_components(
            reasoning_config, config.reasoning.projector_path,
            resolve_repo_path(getattr(config.reasoning, "llm_checkpoint", None)),
            device=device)
        if clear_conversation:
            core.clear_conversation()
        loop = PerceptionReasoningLoop(
            config=reasoning_config,
            timeline_indexer=timeline,
            knowledge_base=kb,
            projector_weights_path=config.reasoning.projector_path,
            reasoning_core=core,
            projectors=projectors,
            device=device,
        )
        loop.start()
        loop.reasoning_core.index_timeline(timeline)
    result.loop = loop
    result.timings = dict(timer.timings)


# (reasoning core, projector bank) shared across videos: building the
# engine and the bank dominates per-video setup, and a benchmark run
# visits many videos.  Keyed on everything that changes the built
# objects; conversation state is cleared per video by process_video.
_LOOP_COMPONENT_CACHE: dict = {}


def _loop_components(reasoning_config: ReasoningCoreConfig,
                     projector_path: Optional[str],
                     llm_checkpoint: Optional[str] = None,
                     device="cuda"):
    key = (repr(sorted(asdict(reasoning_config).items(),
                       key=lambda kv: kv[0])), projector_path,
           llm_checkpoint, str(device))
    if key not in _LOOP_COMPONENT_CACHE:
        from gvl_tpu_torch.agent.core import create_reasoning_core
        from gvl_tpu_torch.models.projector import ProjectorBank

        core = create_reasoning_core(reasoning_config,
                                     checkpoint_path=llm_checkpoint,
                                     device=device)
        projectors = ProjectorBank(reasoning_config, device=device).init()
        if projector_path and Path(projector_path).exists():
            projectors.load_weights(projector_path)
        _LOOP_COMPONENT_CACHE[key] = (core, projectors)
    return _LOOP_COMPONENT_CACHE[key]


def _to_cache_dict(result: ProcessedVideo) -> dict:
    from gvl_tpu_torch.fusion.schema import kb_to_schema_dict

    return {
        "timestamps": np.asarray(result.timestamps, np.float64),
        "siglip_ts": np.asarray([t for t, _ in result.siglip_embeddings]),
        "siglip": (np.stack([e for _, e in result.siglip_embeddings])
                   if result.siglip_embeddings else np.zeros((0, 1152))),
        "videomae_ts": np.asarray([t for t, _ in result.videomae_embeddings]),
        "videomae": (np.stack([e for _, e in result.videomae_embeddings])
                     if result.videomae_embeddings else np.zeros((0, 768))),
        "audio_ts": np.asarray([t for t, _ in result.audio_embeddings]),
        "audio": (np.stack([e for _, e in result.audio_embeddings])
                  if result.audio_embeddings else np.zeros((0, 1024))),
        "events": [
            {
                "timestamp": e.timestamp,
                "modality": e.modality.value,
                "description": e.description,
                "priority": e.priority.value,
                "duration": e.duration,
                "entity_id": e.entity_id,
                "confidence": e.confidence,
            }
            for e in result.timeline.events
        ],
        "knowledge_base": kb_to_schema_dict(result.knowledge_base),
    }


def _restore_from_cache(result: ProcessedVideo, cached: dict) -> None:
    result.timestamps = list(np.asarray(cached.get("timestamps", [])))
    for key, attr in (("siglip", "siglip_embeddings"),
                      ("videomae", "videomae_embeddings"),
                      ("audio", "audio_embeddings")):
        ts = np.asarray(cached.get(f"{key}_ts", []))
        arr = np.asarray(cached.get(key, np.zeros((0,))))
        setattr(result, attr, [(float(t), arr[i]) for i, t in enumerate(ts)])
    for ev in cached.get("events", []):
        result.timeline.add_event(
            timestamp=float(ev["timestamp"]),
            modality=ModalityType(ev["modality"]),
            description=ev["description"],
            priority=EventPriority(int(ev["priority"])),
            duration=float(ev.get("duration", 0.0)),
            entity_id=ev.get("entity_id"),
            confidence=float(ev.get("confidence", 1.0)),
        )
    kb_doc = cached.get("knowledge_base") or {}
    for ent in kb_doc.get("entities", []):
        result.knowledge_base.register_entity(
            ent["entity_id"], ent["label"],
            EntityCategory(ent.get("category", "unknown")),
            timestamp=float(ent.get("first_seen", 0.0)),
        )


def _window(embs: list[tuple[float, np.ndarray]], ts: Optional[float],
            window: float = 30.0) -> Optional[np.ndarray]:
    if not embs:
        return None
    if ts is None:
        chosen = [e for _, e in embs]
    else:
        chosen = [e for t, e in embs if abs(t - ts) <= window]
    return np.stack(chosen) if chosen else None


def answer_query(processed: ProcessedVideo, query: str,
                 timestamp: Optional[float] = None) -> str:
    """One-shot QA with ±30 s multimodal embedding windows."""
    loop = processed.loop
    loop.set_query(query)
    return loop.process_frame(
        timestamp=timestamp or 0.0,
        region_embeddings=_window(processed.siglip_embeddings, timestamp),
        videomae_embeddings=_window(processed.videomae_embeddings, timestamp),
        audio_embeddings=_window(processed.audio_embeddings, timestamp),
        force_reason=True,
    )


def answer_query_streaming(processed: ProcessedVideo, query: str,
                           timestamp: Optional[float] = None):
    """Streaming QA through the reasoning core."""
    loop = processed.loop
    projected = loop.project_embeddings(
        siglip_embeddings=_window(processed.siglip_embeddings, timestamp),
        videomae_embeddings=_window(processed.videomae_embeddings, timestamp),
        audio_embeddings=_window(processed.audio_embeddings, timestamp),
    )
    yield from loop.reasoning_core.reason_streaming(
        query,
        timeline_indexer=loop.timeline_indexer,
        knowledge_base=loop.knowledge_base,
        video_timestamp=timestamp,
        inputs_embeds_prefix=loop.build_embedding_prefix(projected),
    )
