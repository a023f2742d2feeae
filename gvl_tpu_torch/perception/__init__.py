"""Perception of the port: region semantic encoding, concept segmentation
and tracking, OCR, and the encoders' random-weight builds for the card
(counterpart of :mod:`gvl_tpu.perception`)."""

from gvl_tpu_torch.perception.segmenter import (
    BoundingBox,
    EntityState,
    SAMConceptSegmenter,
    SAMConfig,
    SegmentationMask,
    TrackedEntity,
    create_sam_segmenter,
)
from gvl_tpu_torch.perception.ocr import (
    OCRConfig,
    OCRFrame,
    OCRPipeline,
    TextCategorizer,
    TextDetection,
    create_ocr_pipeline,
)
from gvl_tpu_torch.perception.semantic import (
    NaFlexConfig,
    SemanticEmbedding,
    SigLIPSemanticEncoder,
    create_siglip_encoder,
)
from gvl_tpu_torch.perception.open_vocab import (
    OpenVocabSamBackend,
    create_open_vocab_segmenter,
)
from gvl_tpu_torch.perception.batch import (
    build_perception_stack,
    build_segmenter,
    build_siglip_encoder,
    run_batched_perception,
)

__all__ = [
    "EntityState",
    "BoundingBox",
    "SegmentationMask",
    "TrackedEntity",
    "SAMConfig",
    "SAMConceptSegmenter",
    "create_sam_segmenter",
    "OCRConfig",
    "OCRFrame",
    "OCRPipeline",
    "TextCategorizer",
    "TextDetection",
    "create_ocr_pipeline",
    "NaFlexConfig",
    "SemanticEmbedding",
    "SigLIPSemanticEncoder",
    "create_siglip_encoder",
    "build_perception_stack",
    "build_segmenter",
    "build_siglip_encoder",
    "run_batched_perception",
    "OpenVocabSamBackend",
    "create_open_vocab_segmenter",
]
