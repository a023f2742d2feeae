"""Frozen, versioned JSON schema (v1.0.0) for knowledge-base export (the
port's copy of :mod:`gvl_tpu.fusion.schema`).

The schema enums are FROZEN: values may be appended in minor versions but
never renamed or removed, so downstream consumers can rely on
``session.json`` files across framework versions.
"""

from __future__ import annotations

import json
import time
from enum import Enum
from pathlib import Path
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from gvl_tpu_torch.fusion.knowledge_base import KnowledgeBaseBuilder

KB_SCHEMA_VERSION = "1.0.0"


class EntityCategorySchema(Enum):
    """Frozen entity-category vocabulary for JSON export (superset of the
    runtime :class:`~gvl_tpu_torch.fusion.knowledge_base.EntityCategory`)."""

    PLAYER = "player"
    ENEMY = "enemy"
    BOSS = "boss"
    NPC = "npc"
    ITEM = "item"
    PROJECTILE = "projectile"
    UI_ELEMENT = "ui_element"
    ENVIRONMENT = "environment"
    EFFECT = "effect"
    UNKNOWN = "unknown"


class RelationTypeSchema(Enum):
    """Frozen relationship-type vocabulary for JSON export."""

    ATTACKS = "attacks"
    DAMAGES = "damages"
    HEALS = "heals"
    COLLIDES_WITH = "collides_with"
    NEAR = "near"
    CONTAINS = "contains"
    ABOVE = "above"
    BELOW = "below"
    LEFT_OF = "left_of"
    RIGHT_OF = "right_of"
    FOLLOWS = "follows"
    TARGETS = "targets"
    TRANSFORMS_INTO = "transforms_into"
    SPAWNS = "spawns"
    DESTROYS = "destroys"


def get_schema_documentation() -> str:
    """Human-readable summary of the frozen schema."""
    lines = [
        f"Knowledge Base JSON Schema v{KB_SCHEMA_VERSION}",
        "",
        "Top-level keys: schema_version, exported_at, video_source,",
        "  entities[], relationships[], statistics{}",
        "",
        "Entity categories:",
        "  " + ", ".join(c.value for c in EntityCategorySchema),
        "",
        "Relationship types:",
        "  " + ", ".join(r.value for r in RelationTypeSchema),
        "",
        "entity := {entity_id, label, category, first_seen, last_seen,",
        "           is_active, attributes, states: [{timestamp, position,",
        "           bbox, visible, attributes}]}",
        "relationship := {source, target, type, start_time, end_time,",
        "                 confidence, metadata}",
    ]
    return "\n".join(lines)


def kb_to_schema_dict(
    kb: "KnowledgeBaseBuilder", video_source: Optional[str] = None
) -> dict:
    """Serialize a knowledge base to the frozen schema-v1 dict."""
    entities = []
    for node in kb.entities.values():
        entities.append(
            {
                "entity_id": node.entity_id,
                "label": node.concept_label,
                "category": node.category.value,
                "first_seen": node.first_seen,
                "last_seen": node.last_seen,
                "is_active": node.is_active,
                "attributes": node.attributes,
                "states": [
                    {
                        "timestamp": s.timestamp,
                        "position": list(s.position) if s.position else None,
                        "bbox": list(s.bbox) if s.bbox else None,
                        "visible": s.visible,
                        "attributes": s.attributes,
                    }
                    for s in node.state_history
                ],
            }
        )
    relationships = [
        {
            "source": e.source_id,
            "target": e.target_id,
            "type": e.relation_type.value,
            "start_time": e.start_time,
            "end_time": e.end_time,
            "confidence": e.confidence,
            "metadata": e.metadata,
        }
        for e in kb.relationships
    ]
    return {
        "schema_version": KB_SCHEMA_VERSION,
        "exported_at": time.time(),
        "video_source": video_source,
        "entities": entities,
        "relationships": relationships,
        "statistics": kb.get_statistics(),
    }


def kb_from_schema_dict(doc: dict) -> "KnowledgeBaseBuilder":
    """The knowledge base a schema-v1 dict (:func:`kb_to_schema_dict`)
    describes: every entity with its category, times, attributes and state
    history, and every relationship, in their order.  The JAX package has
    no inverse of the export (ROADMAP C13)."""
    from gvl_tpu_torch.fusion.knowledge_base import (
        EntityCategory,
        EntityState,
        KnowledgeBaseBuilder,
        RelationType,
    )

    def as_tuple(value):
        return tuple(value) if value is not None else None

    kb = KnowledgeBaseBuilder()
    for ent in doc.get("entities", []):
        node = kb.register_entity(ent["entity_id"], ent["label"],
                                  EntityCategory(ent.get("category", "unknown")),
                                  timestamp=float(ent.get("first_seen", 0.0)),
                                  attributes=dict(ent.get("attributes") or {}))
        node.last_seen = float(ent.get("last_seen", node.first_seen))
        node.is_active = bool(ent.get("is_active", True))
        node.state_history = [
            EntityState(timestamp=float(st["timestamp"]), position=as_tuple(st.get("position")),
                        bbox=as_tuple(st.get("bbox")), visible=bool(st.get("visible", True)),
                        attributes=dict(st.get("attributes") or {}))
            for st in ent.get("states", [])]
    for rel in doc.get("relationships", []):
        kb.add_relationship(rel["source"], rel["target"], RelationType(rel["type"]),
                            float(rel["start_time"]), end_time=rel.get("end_time"),
                            confidence=float(rel.get("confidence", 1.0)),
                            metadata=dict(rel.get("metadata") or {}))
    return kb


def export_kb_to_json(
    kb: "KnowledgeBaseBuilder",
    path: str | Path,
    video_source: Optional[str] = None,
) -> dict:
    """Write the schema-v1 JSON document to ``path`` and return it."""
    doc = kb_to_schema_dict(kb, video_source=video_source)
    Path(path).write_text(json.dumps(doc, indent=2))
    return doc


def validate_schema_dict(doc: dict) -> list[str]:
    """Return a list of schema violations (empty = valid)."""
    errors: list[str] = []
    version = doc.get("schema_version", "")
    if not version.startswith("1."):
        errors.append(f"unsupported schema_version: {version!r}")
    for key in ("entities", "relationships", "statistics"):
        if key not in doc:
            errors.append(f"missing top-level key: {key}")
    categories = {c.value for c in EntityCategorySchema}
    for ent in doc.get("entities", []):
        for key in ("entity_id", "label", "category"):
            if key not in ent:
                errors.append(f"entity missing key: {key}")
        if ent.get("category") not in categories:
            errors.append(f"unknown entity category: {ent.get('category')!r}")
    rel_types = {r.value for r in RelationTypeSchema}
    for rel in doc.get("relationships", []):
        for key in ("source", "target", "type", "start_time"):
            if key not in rel:
                errors.append(f"relationship missing key: {key}")
        if rel.get("type") not in rel_types:
            errors.append(f"unknown relationship type: {rel.get('type')!r}")
    return errors
