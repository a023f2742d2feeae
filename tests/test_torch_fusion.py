"""gvl_tpu_torch's timeline and knowledge base against gvl_tpu's, on the CPU.

Seeded streams of events and tracked entities (numpy, several seeds) go
into both packages; every rendered surface must be byte-identical: the
structured transcript, the compact event lines after ``merge_and_dedupe``,
the knowledge base's LLM export and its schema dict, and the events the
retriever returns on the port's timeline against JAX's retriever on JAX's
timeline.  No tolerance: host code, exact equality.
"""

from dataclasses import dataclass

import numpy as np
import pytest

from gvl_tpu.agent import retriever as jret
from gvl_tpu.agent.config import ReasoningCoreConfig as JaxReasoningConfig
from gvl_tpu.fusion import knowledge_base as jkb
from gvl_tpu.fusion import schema as jschema
from gvl_tpu.fusion import timeline as jtl
from gvl_tpu_torch.agent import retriever as tret
from gvl_tpu_torch.agent.config import ReasoningCoreConfig
from gvl_tpu_torch.fusion import knowledge_base as tkb
from gvl_tpu_torch.fusion import schema as tschema
from gvl_tpu_torch.fusion import timeline as ttl

SEEDS = (0, 1, 2, 3)
LABELS = ("player", "enemy", "boss", "item")
WORDS = ("enemy ahead take cover", "HP 40/100", "press the button now", "boss drops loot",
         "impact sound", "UI chime", "background music", "GOLD 350", "the bridge is out")


@dataclass
class _Box:
    x1: float
    y1: float
    x2: float
    y2: float

    def to_xyxy(self):
        return (self.x1, self.y1, self.x2, self.y2)


@dataclass
class _Mask:
    bbox: _Box
    confidence: float


@dataclass
class _Entity:
    """A tracked entity as both packages read it (``TrackedEntity``'s fields)."""
    entity_id: str
    concept_label: str
    frame_masks: dict


@dataclass
class _Segment:
    start_time: float
    text: str
    duration: float
    confidence: float
    description: str = ""


@dataclass
class _Audio:
    transcriptions: list
    events: list


def _tracks(rng, n_frames):
    """Per frame: the entities the tracker reports, moving with jitter."""
    ents = [(f"{label}_{k:03d}", label) for label in LABELS
            for k in range(int(rng.integers(0, 3)))]
    frames = []
    for f in range(n_frames):
        out = []
        for eid, label in ents:
            if rng.random() < 0.2:
                continue            # missed this frame
            x, y = rng.uniform(10, 300), rng.uniform(10, 220)
            w, h = rng.uniform(8, 60), rng.uniform(8, 60)
            mask = _Mask(_Box(x, y, x + w, y + h), float(rng.uniform(0.4, 0.99)))
            out.append(_Entity(eid, label, {f: mask}))
        frames.append(out)
    return frames


def _audio(rng, duration):
    speech = [_Segment(float(rng.uniform(0, duration)), str(rng.choice(WORDS)),
                       float(rng.uniform(0.5, 3)), float(rng.uniform(0.3, 0.95)))
              for _ in range(int(rng.integers(0, 4)))]
    events = [_Segment(float(int(rng.uniform(0, duration))), "", 1.0,
                       float(rng.uniform(0.5, 0.99)),
                       description=str(rng.choice(WORDS[4:7])))
              for _ in range(int(rng.integers(0, 6)))]
    return _Audio(speech, events)


def _fill(pkg_tl, pkg_kb, seed):
    """One seeded stream into one package's (timeline, knowledge base)."""
    rng = np.random.default_rng(seed)
    duration = float(rng.choice((10.0, 20.0, 75.0)))
    timeline, kb = pkg_tl.TimelineIndexer(), pkg_kb.KnowledgeBaseBuilder()
    tracks = _tracks(rng, 12)
    for f, ents in enumerate(tracks):
        ts = f * duration / len(tracks)
        timeline.add_from_sam_entities(ents, f, ts)
        kb.update_from_tracking(ents, f, ts)
    timeline.add_from_audio_result(_audio(rng, duration))
    modalities = list(pkg_tl.ModalityType)
    priorities = list(pkg_tl.EventPriority)
    for _ in range(int(rng.integers(5, 30))):
        timeline.add_event(
            float(np.round(rng.uniform(0, duration), 2)),
            modalities[int(rng.integers(0, len(modalities)))],
            str(rng.choice(WORDS)),
            priority=priorities[int(rng.integers(0, len(priorities)))],
            duration=float(rng.choice((0.0, 1.5))),
            entity_id=(None if rng.random() < 0.5
                       else f"{rng.choice(LABELS)}_{int(rng.integers(0, 3)):03d}"),
            confidence=float(rng.uniform(0.3, 1.0)))
    return timeline, kb


@pytest.mark.parametrize("seed", SEEDS)
def test_timeline_renders_byte_identical(seed):
    jt, _ = _fill(jtl, jkb, seed)
    tt, _ = _fill(ttl, tkb, seed)
    assert tt.build_structured_transcript() == jt.build_structured_transcript()
    assert tt.get_statistics() == jt.get_statistics()
    jt.merge_and_dedupe()
    tt.merge_and_dedupe()
    assert [e.format_compact() for e in tt.events] == [e.format_compact() for e in jt.events]
    assert tt.build_structured_transcript() == jt.build_structured_transcript()
    for t0 in (0.0, 5.0, 40.0):
        assert ([e.format_compact() for e in tt.query_around_timestamp(t0, 10.0)]
                == [e.format_compact() for e in jt.query_around_timestamp(t0, 10.0)])


@pytest.mark.parametrize("seed", SEEDS)
def test_knowledge_base_exports_byte_identical(seed):
    _, jk = _fill(jtl, jkb, seed)
    _, tk = _fill(ttl, tkb, seed)
    assert tk.export_for_llm() == jk.export_for_llm()
    assert (tk.export_for_llm(max_entities=15, max_relationships=20)
            == jk.export_for_llm(max_entities=15, max_relationships=20))
    assert tk.get_statistics() == jk.get_statistics()
    want, got = jschema.kb_to_schema_dict(jk), tschema.kb_to_schema_dict(tk)
    want.pop("exported_at", None)
    got.pop("exported_at", None)
    assert got == want
    for ts in (0.0, 7.5):
        jk.infer_relationships_at(ts)
        tk.infer_relationships_at(ts)
    assert tk.export_for_llm() == jk.export_for_llm()


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_hybrid_retrieve_on_the_ports_timeline(seed):
    """The port's retriever over the port's timeline returns the events that
    JAX's retriever returns over JAX's (hashing embedder: exact)."""
    jt, _ = _fill(jtl, jkb, seed)
    tt, _ = _fill(ttl, tkb, seed)
    jt.merge_and_dedupe()
    tt.merge_and_dedupe()
    want_r = jret.TimelineRetriever(JaxReasoningConfig(embedding_model="hashing"))
    got_r = tret.TimelineRetriever(ReasoningCoreConfig(embedding_model="hashing"),
                                   device="cpu")
    want_r.index_timeline(jt)
    got_r.index_timeline(tt)
    for q in ("does a boss appear", "what does the voice say", "what happened at 00:05",
              "around 40 seconds", "HP"):
        want = [e.format_compact() for e in want_r.hybrid_retrieve(q, jt)]
        got = [e.format_compact() for e in got_r.hybrid_retrieve(q, tt)]
        assert got == want, q
