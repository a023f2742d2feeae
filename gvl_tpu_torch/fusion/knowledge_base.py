"""Entity-centric knowledge graph over tracked gameplay entities (the port's
copy of :mod:`gvl_tpu.fusion.knowledge_base`).

Nodes are persistent entities (from the tracker) with full state
histories; edges are typed, time-scoped relationships.  Spatial and
collision relationships are inferred per timestep with vectorized numpy
over all entity pairs, and the graph exports as a table, a node/edge
dict, or a compact text block for LLM prompting, held byte-identical to
the JAX package's export (``tests/test_torch_fusion.py``).
"""

from __future__ import annotations

import bisect
import logging
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional

import numpy as np

logger = logging.getLogger(__name__)


class RelationType(Enum):
    """Typed relationships between entities."""

    # spatial
    NEAR = "near"
    CONTAINS = "contains"
    ABOVE = "above"
    BELOW = "below"
    LEFT_OF = "left_of"
    RIGHT_OF = "right_of"
    # interaction
    ATTACKS = "attacks"
    HEALS = "heals"
    COLLIDES_WITH = "collides_with"
    FOLLOWS = "follows"
    TARGETS = "targets"
    # state
    TRANSFORMS_INTO = "transforms_into"
    SPAWNS = "spawns"
    DESTROYS = "destroys"


class EntityCategory(Enum):
    """Coarse gameplay role of an entity."""

    PLAYER = "player"
    ENEMY = "enemy"
    NPC = "npc"
    ITEM = "item"
    PROJECTILE = "projectile"
    UI_ELEMENT = "ui_element"
    ENVIRONMENT = "environment"
    EFFECT = "effect"
    UNKNOWN = "unknown"


@dataclass
class EntityState:
    """Snapshot of one entity at one timestamp."""

    timestamp: float
    position: Optional[tuple[float, float]] = None  # center (x, y)
    bbox: Optional[tuple[float, float, float, float]] = None  # x1,y1,x2,y2
    visible: bool = True
    attributes: dict = field(default_factory=dict)

    def distance_to(self, other: "EntityState") -> Optional[float]:
        if self.position is None or other.position is None:
            return None
        return float(np.hypot(
            self.position[0] - other.position[0],
            self.position[1] - other.position[1],
        ))


@dataclass
class EntityNode:
    """Graph node: persistent entity identity + time-ordered state history."""

    entity_id: str
    concept_label: str
    category: EntityCategory = EntityCategory.UNKNOWN
    first_seen: float = 0.0
    last_seen: float = 0.0
    is_active: bool = True
    state_history: list[EntityState] = field(default_factory=list)
    attributes: dict = field(default_factory=dict)

    def add_state(self, state: EntityState) -> None:
        self.state_history.append(state)
        self.last_seen = max(self.last_seen, state.timestamp)

    def get_state_at(self, timestamp: float) -> Optional[EntityState]:
        """Closest-in-time state (histories are appended in time order, so a
        binary search over timestamps finds the neighbor pair)."""
        hist = self.state_history
        if not hist:
            return None
        keys = [s.timestamp for s in hist]
        i = bisect.bisect_left(keys, timestamp)
        if i == 0:
            return hist[0]
        if i == len(hist):
            return hist[-1]
        before, after = hist[i - 1], hist[i]
        return before if timestamp - before.timestamp <= after.timestamp - timestamp else after

    def get_latest_state(self) -> Optional[EntityState]:
        if not self.state_history:
            return None
        return max(self.state_history, key=lambda s: s.timestamp)

    def get_attribute_changes(self, attr_name: str) -> list[tuple[float, Any, Any]]:
        """(timestamp, old, new) triples each time ``attr_name`` changes."""
        changes: list[tuple[float, Any, Any]] = []
        prev: Any = None
        for state in sorted(self.state_history, key=lambda s: s.timestamp):
            cur = state.attributes.get(attr_name)
            if cur != prev:
                changes.append((state.timestamp, prev, cur))
                prev = cur
        return changes


@dataclass
class RelationshipEdge:
    """Graph edge: a typed relationship with a temporal scope."""

    source_id: str
    target_id: str
    relation_type: RelationType
    start_time: float
    end_time: Optional[float] = None  # None = ongoing
    confidence: float = 1.0
    metadata: dict = field(default_factory=dict)

    @property
    def is_active(self) -> bool:
        return self.end_time is None

    @property
    def duration(self) -> Optional[float]:
        return None if self.end_time is None else self.end_time - self.start_time

    def format_description(self) -> str:
        return f"{self.source_id} {self.relation_type.value} {self.target_id}"


@dataclass
class KnowledgeBaseConfig:
    """Thresholds for relationship inference and export limits."""

    proximity_threshold: float = 50.0     # px for NEAR
    collision_iou_threshold: float = 0.3  # IoU for COLLIDES_WITH
    infer_spatial_relations: bool = True
    infer_interactions: bool = True
    relation_timeout: float = 5.0
    max_history_per_entity: int = 100
    include_inactive_entities: bool = False


def _pairwise_iou(boxes: np.ndarray) -> np.ndarray:
    """All-pairs IoU over an (N, 4) xyxy array (NaN rows yield 0)."""
    x1 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    areas = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(
        boxes[:, 3] - boxes[:, 1], 0, None
    )
    union = areas[:, None] + areas[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return np.nan_to_num(iou, nan=0.0)


class RelationshipInferrer:
    """Derives spatial/collision edges from entity states.

    Inference rules (matching the reference): NEAR when center distance <
    ``proximity_threshold``; exactly one directional relation per pair chosen
    by the dominant axis of the center delta (ties go to the vertical axis);
    CONTAINS when entity2's bbox lies inside entity1's; COLLIDES_WITH when
    bbox IoU >= ``collision_iou_threshold``.
    """

    def __init__(self, config: KnowledgeBaseConfig):
        self.config = config

    def infer_spatial_relations(
        self, entity1: EntityNode, entity2: EntityNode, timestamp: float
    ) -> list[RelationType]:
        s1, s2 = entity1.get_state_at(timestamp), entity2.get_state_at(timestamp)
        if s1 is None or s2 is None:
            return []
        return self._spatial_from_states(s1, s2)

    def _spatial_from_states(
        self, s1: EntityState, s2: EntityState
    ) -> list[RelationType]:
        relations: list[RelationType] = []
        dist = s1.distance_to(s2)
        if dist is not None and dist < self.config.proximity_threshold:
            relations.append(RelationType.NEAR)
        if s1.position and s2.position:
            dx = s2.position[0] - s1.position[0]
            dy = s2.position[1] - s1.position[1]
            if abs(dx) > abs(dy):
                relations.append(
                    RelationType.LEFT_OF if dx > 0 else RelationType.RIGHT_OF
                )
            else:
                relations.append(
                    RelationType.ABOVE if dy > 0 else RelationType.BELOW
                )
        if s1.bbox and s2.bbox and self._contained(s2.bbox, s1.bbox):
            relations.append(RelationType.CONTAINS)
        return relations

    def infer_collision(
        self, entity1: EntityNode, entity2: EntityNode, timestamp: float
    ) -> bool:
        s1, s2 = entity1.get_state_at(timestamp), entity2.get_state_at(timestamp)
        if s1 is None or s2 is None or s1.bbox is None or s2.bbox is None:
            return False
        boxes = np.array([s1.bbox, s2.bbox], dtype=np.float64)
        return bool(_pairwise_iou(boxes)[0, 1] >= self.config.collision_iou_threshold)

    @staticmethod
    def _contained(
        inner: tuple[float, float, float, float],
        outer: tuple[float, float, float, float],
    ) -> bool:
        return (
            inner[0] >= outer[0]
            and inner[1] >= outer[1]
            and inner[2] <= outer[2]
            and inner[3] <= outer[3]
        )


class KnowledgeBaseBuilder:
    """Builds and queries the entity knowledge graph.

    Example::

        kb = KnowledgeBaseBuilder()
        kb.register_entity("player_001", "player", EntityCategory.PLAYER)
        kb.add_relationship("player_001", "boss_dragon_001",
                            RelationType.ATTACKS, timestamp=83.0)
        kb.export_for_llm()
    """

    def __init__(self, config: Optional[KnowledgeBaseConfig] = None):
        self.config = config or KnowledgeBaseConfig()
        self.inferrer = RelationshipInferrer(self.config)
        self._entities: dict[str, EntityNode] = {}
        self._relationships: list[RelationshipEdge] = []
        self._edges_out: dict[str, list[RelationshipEdge]] = {}
        self._edges_in: dict[str, list[RelationshipEdge]] = {}

    # --------------------------------------------------------------- update

    def update_from_tracking(
        self, tracked_entities: list[Any], frame_idx: int, timestamp: float
    ) -> None:
        """Ingest one frame of tracker output (duck-typed ``TrackedEntity``:
        needs ``entity_id``, ``concept_label``, ``frame_masks[frame_idx].bbox``).
        """
        for ent in tracked_entities:
            mask = ent.frame_masks.get(frame_idx)
            if mask is None:
                continue
            bbox = self._coerce_bbox(getattr(mask, "bbox", None))
            position = None
            if bbox is not None:
                position = ((bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2)
            state = EntityState(
                timestamp=timestamp, position=position, bbox=bbox, visible=True
            )
            if ent.entity_id not in self._entities:
                self.register_entity(
                    entity_id=ent.entity_id,
                    concept_label=ent.concept_label,
                    category=EntityCategory.UNKNOWN,
                    timestamp=timestamp,
                    initial_state=state,
                )
            else:
                self.update_entity_state(
                    entity_id=ent.entity_id,
                    timestamp=timestamp,
                    position=position,
                    bbox=bbox,
                    visible=True,
                )
        self.infer_relationships_at(timestamp)

    @staticmethod
    def _coerce_bbox(bbox: Any) -> Optional[tuple[float, float, float, float]]:
        if bbox is None:
            return None
        if hasattr(bbox, "to_xyxy"):
            return tuple(bbox.to_xyxy())
        if isinstance(bbox, (list, tuple)) and len(bbox) == 4:
            return tuple(bbox)
        return None

    def register_entity(
        self,
        entity_id: str,
        concept_label: str,
        category: EntityCategory = EntityCategory.UNKNOWN,
        timestamp: float = 0.0,
        initial_state: Optional[EntityState] = None,
        attributes: Optional[dict] = None,
    ) -> EntityNode:
        """Create a node, or refresh last_seen/state on an existing one."""
        node = self._entities.get(entity_id)
        if node is not None:
            node.last_seen = max(node.last_seen, timestamp)
            if initial_state:
                node.add_state(initial_state)
            return node
        node = EntityNode(
            entity_id=entity_id,
            concept_label=concept_label,
            category=category,
            first_seen=timestamp,
            last_seen=timestamp,
            attributes=attributes or {},
        )
        if initial_state:
            node.add_state(initial_state)
        self._entities[entity_id] = node
        self._edges_out[entity_id] = []
        self._edges_in[entity_id] = []
        return node

    def update_entity_state(
        self,
        entity_id: str,
        timestamp: float,
        position: Optional[tuple[float, float]] = None,
        bbox: Optional[tuple[float, float, float, float]] = None,
        visible: bool = True,
        attributes: Optional[dict] = None,
    ) -> None:
        node = self._entities.get(entity_id)
        if node is None:
            logger.warning("update_entity_state: unknown entity %s", entity_id)
            return
        node.add_state(
            EntityState(
                timestamp=timestamp,
                position=position,
                bbox=bbox,
                visible=visible,
                attributes=attributes or {},
            )
        )
        cap = self.config.max_history_per_entity
        if len(node.state_history) > cap:
            del node.state_history[:-cap]

    def add_relationship(
        self,
        source_id: str,
        target_id: str,
        relation_type: RelationType,
        timestamp: float,
        end_time: Optional[float] = None,
        confidence: float = 1.0,
        metadata: Optional[dict] = None,
    ) -> RelationshipEdge:
        edge = RelationshipEdge(
            source_id=source_id,
            target_id=target_id,
            relation_type=relation_type,
            start_time=timestamp,
            end_time=end_time,
            confidence=confidence,
            metadata=metadata or {},
        )
        self._relationships.append(edge)
        if source_id in self._edges_out:
            self._edges_out[source_id].append(edge)
        if target_id in self._edges_in:
            self._edges_in[target_id].append(edge)
        return edge

    def end_relationship(
        self,
        source_id: str,
        target_id: str,
        relation_type: RelationType,
        end_time: float,
    ) -> bool:
        for edge in self._edges_out.get(source_id, []):
            if (
                edge.target_id == target_id
                and edge.relation_type is relation_type
                and edge.is_active
            ):
                edge.end_time = end_time
                return True
        return False

    # ------------------------------------------------------------ inference

    def infer_relationships_at(self, timestamp: float) -> list[RelationshipEdge]:
        """Vectorized all-pairs spatial + collision inference at one instant.

        States nearest to ``timestamp`` are gathered into (N,2) position and
        (N,4) bbox arrays (NaN where absent); distances and IoUs for every
        pair come from two numpy broadcasts, then edges are materialized for
        pairs passing the thresholds.  Spatial edges carry confidence 0.8,
        collisions 0.9.
        """
        nodes = [n for n in self._entities.values() if n.is_active]
        n = len(nodes)
        if n < 2:
            return []
        states = [node.get_state_at(timestamp) for node in nodes]

        pos = np.full((n, 2), np.nan)
        box = np.full((n, 4), np.nan)
        for i, s in enumerate(states):
            if s is None:
                continue
            if s.position is not None:
                pos[i] = s.position
            if s.bbox is not None:
                box[i] = s.bbox

        delta = pos[None, :, :] - pos[:, None, :]  # [i, j] = pos_j - pos_i
        dist = np.hypot(delta[..., 0], delta[..., 1])
        iou = _pairwise_iou(box)
        contains = (
            (box[None, :, 0] >= box[:, None, 0])
            & (box[None, :, 1] >= box[:, None, 1])
            & (box[None, :, 2] <= box[:, None, 2])
            & (box[None, :, 3] <= box[:, None, 3])
        )

        inferred: list[RelationshipEdge] = []

        def emit(i: int, j: int, rel: RelationType, conf: float) -> None:
            inferred.append(
                self.add_relationship(
                    nodes[i].entity_id,
                    nodes[j].entity_id,
                    rel,
                    timestamp=timestamp,
                    confidence=conf,
                )
            )

        for i in range(n):
            for j in range(i + 1, n):
                if states[i] is None or states[j] is None:
                    continue
                if self.config.infer_spatial_relations:
                    if dist[i, j] < self.config.proximity_threshold:
                        emit(i, j, RelationType.NEAR, 0.8)
                    dx, dy = delta[i, j]
                    if not (np.isnan(dx) or np.isnan(dy)):
                        if abs(dx) > abs(dy):
                            emit(
                                i, j,
                                RelationType.LEFT_OF if dx > 0 else RelationType.RIGHT_OF,
                                0.8,
                            )
                        else:
                            emit(
                                i, j,
                                RelationType.ABOVE if dy > 0 else RelationType.BELOW,
                                0.8,
                            )
                    if contains[i, j]:
                        emit(i, j, RelationType.CONTAINS, 0.8)
                if (
                    self.config.infer_interactions
                    and iou[i, j] >= self.config.collision_iou_threshold
                ):
                    emit(i, j, RelationType.COLLIDES_WITH, 0.9)
        return inferred

    # ---------------------------------------------------------------- query

    def get_entity(self, entity_id: str) -> Optional[EntityNode]:
        return self._entities.get(entity_id)

    def get_entities_by_category(self, category: EntityCategory) -> list[EntityNode]:
        return [e for e in self._entities.values() if e.category is category]

    def query_entity_history(
        self,
        entity_id: str,
        start_time: Optional[float] = None,
        end_time: Optional[float] = None,
    ) -> list[EntityState]:
        node = self._entities.get(entity_id)
        if node is None:
            return []
        states = node.state_history
        if start_time is not None:
            states = [s for s in states if s.timestamp >= start_time]
        if end_time is not None:
            states = [s for s in states if s.timestamp <= end_time]
        return sorted(states, key=lambda s: s.timestamp)

    def get_relationships_for_entity(
        self, entity_id: str, as_source: bool = True, as_target: bool = True
    ) -> list[RelationshipEdge]:
        edges: list[RelationshipEdge] = []
        if as_source:
            edges.extend(self._edges_out.get(entity_id, []))
        if as_target:
            edges.extend(self._edges_in.get(entity_id, []))
        return edges

    def get_active_relationships(
        self, timestamp: Optional[float] = None
    ) -> list[RelationshipEdge]:
        return [
            e
            for e in self._relationships
            if e.is_active or (timestamp and e.end_time and e.end_time > timestamp)
        ]

    def get_entity_relationship_summary(self, entity_id: str) -> str:
        node = self._entities.get(entity_id)
        if node is None:
            return f"Entity {entity_id} not found."
        lines = [
            f"Entity: {node.entity_id} ({node.concept_label})",
            f"Category: {node.category.value}",
            f"Active: {node.is_active}",
            f"Seen: {node.first_seen:.1f}s - {node.last_seen:.1f}s",
        ]
        out = self._edges_out.get(entity_id, [])
        inc = self._edges_in.get(entity_id, [])
        if out:
            lines.append("Outgoing relationships:")
            lines.extend(f"  - {e.format_description()}" for e in out[:5])
        if inc:
            lines.append("Incoming relationships:")
            lines.extend(f"  - {e.format_description()}" for e in inc[:5])
        return "\n".join(lines)

    # --------------------------------------------------------------- export

    def _exportable_entities(self) -> list[EntityNode]:
        nodes = self._entities.values()
        if not self.config.include_inactive_entities:
            nodes = (e for e in nodes if e.is_active)
        return list(nodes)

    def export_as_table(self) -> list[dict]:
        rows = []
        for node in self._exportable_entities():
            latest = node.get_latest_state()
            rows.append(
                {
                    "entity_id": node.entity_id,
                    "label": node.concept_label,
                    "category": node.category.value,
                    "first_seen": node.first_seen,
                    "last_seen": node.last_seen,
                    "is_active": node.is_active,
                    "position": latest.position if latest else None,
                    "outgoing_relations": len(self._edges_out.get(node.entity_id, [])),
                    "incoming_relations": len(self._edges_in.get(node.entity_id, [])),
                    "attributes": node.attributes,
                }
            )
        return rows

    def export_as_graph(self) -> dict:
        nodes = [
            {
                "id": e.entity_id,
                "label": e.concept_label,
                "category": e.category.value,
            }
            for e in self._exportable_entities()
        ]
        edges = [
            {
                "source": e.source_id,
                "target": e.target_id,
                "type": e.relation_type.value,
                "start_time": e.start_time,
                "end_time": e.end_time,
            }
            for e in self._relationships
        ]
        return {"nodes": nodes, "edges": edges}

    def export_for_llm(
        self, max_entities: int = 20, max_relationships: int = 30
    ) -> str:
        """Compact markdown block for prompt context: most-recent entities
        first, then most-recent relationships."""
        lines = ["## Entity Knowledge Base", "", "### Entities"]
        nodes = sorted(
            self._exportable_entities(), key=lambda e: e.last_seen, reverse=True
        )[:max_entities]
        for node in nodes:
            latest = node.get_latest_state()
            pos = ""
            if latest and latest.position:
                pos = f" at ({latest.position[0]:.0f}, {latest.position[1]:.0f})"
            lines.append(
                f"- **{node.entity_id}**: {node.concept_label} "
                f"({node.category.value}){pos}"
            )
        lines += ["", "### Relationships"]
        recent = sorted(
            self._relationships, key=lambda e: e.start_time, reverse=True
        )[:max_relationships]
        for edge in recent:
            status = "ongoing" if edge.is_active else f"ended {edge.end_time:.1f}s"
            lines.append(
                f"- [{edge.start_time:.1f}s] {edge.source_id} "
                f"{edge.relation_type.value} {edge.target_id} ({status})"
            )
        return "\n".join(lines)

    def export_to_json(self, path: str, video_source: Optional[str] = None) -> dict:
        """Versioned JSON export (schema v1) — see :mod:`gvl_tpu_torch.fusion.schema`."""
        from gvl_tpu_torch.fusion import schema

        return schema.export_kb_to_json(self, path, video_source=video_source)

    def get_statistics(self) -> dict:
        by_cat: dict[str, int] = {}
        for node in self._entities.values():
            by_cat[node.category.value] = by_cat.get(node.category.value, 0) + 1
        by_rel: dict[str, int] = {}
        for edge in self._relationships:
            by_rel[edge.relation_type.value] = by_rel.get(edge.relation_type.value, 0) + 1
        return {
            "total_entities": len(self._entities),
            "active_entities": sum(1 for e in self._entities.values() if e.is_active),
            "total_relationships": len(self._relationships),
            "active_relationships": sum(1 for r in self._relationships if r.is_active),
            "entities_by_category": by_cat,
            "relationships_by_type": by_rel,
        }

    def clear(self) -> None:
        self._entities.clear()
        self._relationships.clear()
        self._edges_out.clear()
        self._edges_in.clear()

    @property
    def entities(self) -> dict[str, EntityNode]:
        return self._entities

    @property
    def relationships(self) -> list[RelationshipEdge]:
        return self._relationships


def create_knowledge_base(
    proximity_threshold: float = 50.0,
    infer_relations: bool = True,
) -> KnowledgeBaseBuilder:
    """Factory with the framework's default thresholds."""
    return KnowledgeBaseBuilder(
        KnowledgeBaseConfig(
            proximity_threshold=proximity_threshold,
            infer_spatial_relations=infer_relations,
            infer_interactions=infer_relations,
        )
    )
