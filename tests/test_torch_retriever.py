"""gvl_tpu_torch's retrieval stack against gvl_tpu's, on the CPU: the byte
tokenizer, the SigLIP text tower, the trained retriever
(``outputs/retriever``), the hashing embedder, the embedder ladder and
``TimelineRetriever``.

Tolerances: token ids and hashing vectors exactly equal; the text tower in
f32 within 1e-5 (tiny geometry, no reduction longer than 64) and the
trained embeddings (unit vectors) within 1e-4; top-1 and retrieved events
identical.  The JAX tower's attention runs as its tests run it here
(XLA), the port's through the flash wrapper's plain version.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.agent import retriever as jret
from gvl_tpu.agent.config import ReasoningCoreConfig
from gvl_tpu.fusion.timeline import ModalityType, TimelineIndexer
from gvl_tpu.models import siglip as jsig
from gvl_tpu.training import retriever_train as jrt
from gvl_tpu_torch.agent import retriever as tret
from gvl_tpu_torch.agent import config as port_config
from gvl_tpu_torch.fusion import timeline as port_timeline
from gvl_tpu_torch.models import siglip as tsig
from gvl_tpu_torch.models.convert import siglip_text_params_from_jax
from gvl_tpu_torch.nn.layers import load_module
from gvl_tpu_torch.training import retriever_train as trt

REPO = Path(__file__).resolve().parents[1]
RETRIEVER = REPO / "outputs" / "retriever"

TEXTS = ["when does the hero appear", "", "HP 100/100", "the boss drops loot at 01:23",
         "Ünïcödé bytes count twice", "x" * 100, "Voice chatter: \"go left\""]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side in one thread: these tests run many small ops (a
    decode step, one query), which thread pools shared with the suite's
    other workers slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(n, seed=0):
    rng = np.random.default_rng(seed)
    queries, descs, seen = [], [], set()
    while len(descs) < n:
        q, d, _ = jrt.make_pair(rng)
        if d not in seen:
            seen.add(d)
            queries.append(q)
            descs.append(d)
    return queries, descs


@pytest.fixture(scope="module")
def embedders():
    return (jrt.TrainedTextEmbedder.from_dir(RETRIEVER),
            trt.TrainedTextEmbedder.from_dir(RETRIEVER, device="cpu"))


@pytest.mark.parametrize("max_position", [8, 64])
def test_tokenize_byte_equal(max_position):
    got = trt.tokenize(TEXTS, max_position)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jrt.tokenize(TEXTS, max_position))


def test_text_tower_matches_jax_tiny():
    cfg = jsig.SigLIPTextConfig.tiny()
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, cfg.max_position))
    params = jsig.SigLIPTextTower(cfg).init(jax.random.PRNGKey(0),
                                            jnp.asarray(ids, jnp.int32))["params"]
    want = jsig.SigLIPTextTower(cfg).apply({"params": params}, jnp.asarray(ids, jnp.int32))
    with torch.device("meta"):
        tower = tsig.SigLIPTextTower(tsig.SigLIPTextConfig.tiny())
    state = siglip_text_params_from_jax(jax.tree.map(np.asarray, params), cfg.num_layers)
    tower = load_module(tower, state, "cpu")
    with torch.no_grad():
        got = tower(torch.from_numpy(ids))
    for key in ("pooled", "last_hidden_state"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=0)


def test_trained_embeddings_and_top1_match_jax(embedders):
    jax_emb, port_emb = embedders
    queries, descs = _pairs(64)
    want_d, got_d = jax_emb.encode(descs), port_emb.encode(descs)
    want_q, got_q = jax_emb.encode(queries), port_emb.encode(queries)
    np.testing.assert_allclose(got_d, want_d, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_q, want_q, atol=1e-4, rtol=0)
    np.testing.assert_array_equal((got_q @ got_d.T).argmax(1), (want_q @ want_d.T).argmax(1))
    assert port_emb.encode([]).shape == (0, 256)


def test_hashing_vectors_byte_equal():
    for dim in (64, 256):
        got = tret.HashingTextEmbedder(dim).encode(TEXTS)
        want = jret.HashingTextEmbedder(dim).encode(TEXTS)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["auto", "hashing", str(RETRIEVER), "no/such/model"])
def test_make_embedder_takes_the_same_rung(name, monkeypatch):
    # a name that is no directory falls to sentence-transformers, then to
    # hashing: both ladders see the package missing (importing it takes
    # about 20 s on a CPU host)
    monkeypatch.setitem(__import__("sys").modules, "sentence_transformers", None)
    want = jret.make_embedder(ReasoningCoreConfig(embedding_model=name))
    got = tret.make_embedder(port_config.ReasoningCoreConfig(embedding_model=name), device="cpu")
    assert type(got).__name__ == type(want).__name__


def test_make_embedder_minilm_rung_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="A10"):
        tret.make_embedder(port_config.ReasoningCoreConfig(embedding_model=str(tmp_path)),
                           device="cpu")


def _timeline(descs, package=None):
    """The same events in JAX's timeline, or in the port's (``package``)."""
    indexer, modality = ((TimelineIndexer, ModalityType) if package is None else
                         (package.TimelineIndexer, package.ModalityType))
    idx = indexer()
    for i, d in enumerate(descs):
        idx.add_event(timestamp=7.0 * i, modality=modality.VISUAL, description=d)
    return idx


def _events(events):
    return [(e.timestamp, e.modality.value, e.description) for e in events]


@pytest.mark.parametrize("rung", ["trained", "hashing"])
def test_hybrid_retrieve_same_events(embedders, rung):
    queries, descs = _pairs(24, seed=1)
    idx, port_idx = _timeline(descs), _timeline(descs, port_timeline)
    if rung == "trained":
        jax_emb, port_emb = embedders
    else:
        jax_emb, port_emb = jret.HashingTextEmbedder(256), tret.HashingTextEmbedder(256)
    want_r = jret.TimelineRetriever(ReasoningCoreConfig(), embedder=jax_emb)
    got_r = tret.TimelineRetriever(port_config.ReasoningCoreConfig(), embedder=port_emb)
    want_r.index_timeline(idx)
    got_r.index_timeline(port_idx)
    asks = queries[:8] + ["what happened at 00:42", "around 70 seconds what did the boss do",
                          "at 1:02:03 the hero", "show events at 21 sec"]
    for q in asks:
        assert got_r.parse_timestamp(q) == want_r.parse_timestamp(q)
        for want_kw, got_kw in (({}, {}), ({"timeline_indexer": idx},
                                           {"timeline_indexer": port_idx})):
            want = _events(want_r.hybrid_retrieve(q, **want_kw))
            got = _events(got_r.hybrid_retrieve(q, **got_kw))
            assert got == want, q
