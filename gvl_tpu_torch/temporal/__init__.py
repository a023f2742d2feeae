"""Temporal processing: hierarchical token compression, clip embeddings and
the context hierarchy (counterpart of :mod:`gvl_tpu.temporal`)."""

from gvl_tpu_torch.temporal.hico import (
    CompressionLevel,
    HiCoConfig,
    HierarchicalCompressor,
    TemporalCompressionModule,
    TemporalToken,
    create_hico_module,
)
from gvl_tpu_torch.temporal.context_manager import ContextLevel, TemporalContextManager

__all__ = [
    "CompressionLevel",
    "TemporalToken",
    "HiCoConfig",
    "HierarchicalCompressor",
    "TemporalCompressionModule",
    "create_hico_module",
    "ContextLevel",
    "TemporalContextManager",
]
