"""Fusion & indexing: the LLM's retrieval-ready external memory (the
port's copy of :mod:`gvl_tpu.fusion`).

Aligns every perception modality onto one timeline and maintains an
entity-centric knowledge graph.  Pure host-side Python: these structures
are the interface between the device programs and the reasoning prompts,
so they live on the host and stay deterministic.
"""

from gvl_tpu_torch.fusion.timeline import (
    EventPriority,
    ModalityType,
    TimelineConfig,
    TimelineEvent,
    TimelineIndexer,
    TimelineSegment,
    create_timeline_indexer,
)
from gvl_tpu_torch.fusion.knowledge_base import (
    EntityCategory,
    EntityNode,
    EntityState,
    KnowledgeBaseBuilder,
    KnowledgeBaseConfig,
    RelationType,
    RelationshipEdge,
    create_knowledge_base,
)
from gvl_tpu_torch.fusion.schema import (
    KB_SCHEMA_VERSION,
    EntityCategorySchema,
    RelationTypeSchema,
    get_schema_documentation,
)

__all__ = [
    "ModalityType",
    "EventPriority",
    "TimelineEvent",
    "TimelineSegment",
    "TimelineConfig",
    "TimelineIndexer",
    "create_timeline_indexer",
    "RelationType",
    "EntityCategory",
    "EntityState",
    "EntityNode",
    "RelationshipEdge",
    "KnowledgeBaseConfig",
    "KnowledgeBaseBuilder",
    "create_knowledge_base",
    "KB_SCHEMA_VERSION",
    "EntityCategorySchema",
    "RelationTypeSchema",
    "get_schema_documentation",
]
