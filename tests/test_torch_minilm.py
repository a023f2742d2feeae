"""gvl_tpu_torch's MiniLM encoder against gvl_tpu's and HF ``BertModel``.

A tiny random ``BertModel`` (the geometry of ``tests/test_minilm.py``)
goes through JAX's ``convert_hf_bert`` and the port's.  Port against JAX:
f32, within 1e-5 of the largest magnitude; port against ``transformers``:
within 1e-4 (live positions: HF computes the padded ones otherwise, and
pooling drops them).  Then the sentence encoder's buckets and the MiniLM
rung of ``make_embedder`` on a saved directory with an offline
``BertTokenizer``, and C15: a directory that resolves but cannot be loaded
falls through to hashing in JAX and raises in the port.
"""

import os

os.environ.setdefault("USE_TF", "0")
os.environ["HF_HUB_OFFLINE"] = "1"        # local directories only
os.environ["TRANSFORMERS_OFFLINE"] = "1"

import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gvl_tpu.models import minilm as jax_minilm  # noqa: E402
from gvl_tpu_torch.models import minilm  # noqa: E402

JAX_SHARE = 1e-5
HF_SHARE = 1e-4
WORDS = ("the boss appears at the gate player health is low an item drops enemy "
         "defeated near bridge cave top of screen takes damage moves left right").split()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_share(got, want, share):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= share * np.abs(want).max(), (err, np.abs(want).max())


def hf_bert_config():
    from transformers import BertConfig

    return BertConfig(vocab_size=512, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64,
                      max_position_embeddings=64, type_vocab_size=2,
                      hidden_act="gelu", layer_norm_eps=1e-12)


@pytest.fixture(scope="module")
def hf_bert():
    from transformers import BertModel

    torch.manual_seed(0)
    return BertModel(hf_bert_config(), add_pooling_layer=False).eval()


@pytest.fixture(scope="module")
def models(hf_bert):
    cfg = minilm.MiniLMConfig.tiny()
    sd = hf_bert.state_dict()
    port = minilm.load_minilm(cfg, minilm.convert_hf_bert(sd, cfg), device="cpu")
    jcfg = jax_minilm.MiniLMConfig.tiny()
    jvars = {"params": jax_minilm.convert_hf_bert(sd, jcfg)}
    return port, jax_minilm.MiniLMModel(jcfg), jvars


def _ids(seed, shape):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 512, shape)
    mask = np.ones_like(ids)
    mask[1, 8:] = 0
    return ids, mask


def test_last_hidden_state_matches_jax_and_hf(models, hf_bert):
    port, jmodel, jvars = models
    ids, mask = _ids(0, (3, 12))
    mask[2, 3:] = 0
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        ref = hf_bert(input_ids=torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
    want = np.asarray(jax.jit(jmodel.apply)(jvars, jnp.asarray(ids), jnp.asarray(mask)))
    assert_share(got, want, JAX_SHARE)
    for row, live in ((0, 12), (1, 8), (2, 3)):
        assert_share(got[row, :live], ref[row, :live], HF_SHARE)


def test_mean_pool_normalize_matches_jax_and_the_st_recipe(models, hf_bert):
    port, jmodel, jvars = models
    ids, mask = _ids(1, (3, 10))
    with torch.no_grad():
        got = minilm.mean_pool_normalize(
            port(torch.from_numpy(ids), torch.from_numpy(mask)),
            torch.from_numpy(mask)).numpy()
        hidden = hf_bert(input_ids=torch.from_numpy(ids),
                         attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
    m = mask[..., None].astype(np.float32)
    ref = (hidden * m).sum(1) / np.maximum(m.sum(1), 1e-9)
    ref /= np.linalg.norm(ref, axis=-1, keepdims=True)
    want = np.asarray(jax_minilm.mean_pool_normalize(
        jax.jit(jmodel.apply)(jvars, jnp.asarray(ids), jnp.asarray(mask)), jnp.asarray(mask)))
    assert_share(got, want, JAX_SHARE)
    assert_share(got, ref, HF_SHARE)


def _word_tokenize(texts, max_len):
    """Word ids 1..len(WORDS) after a [CLS]-like 2, right-padded."""
    ids = np.zeros((len(texts), max_len), np.int64)
    mask = np.zeros_like(ids)
    for i, text in enumerate(texts):
        toks = [2] + [WORDS.index(w) + 3 for w in text.split() if w in WORDS]
        toks = toks[:max_len]
        ids[i, :len(toks)], mask[i, :len(toks)] = toks, 1
    return ids, mask


@pytest.mark.parametrize("n", [3, 17])
def test_sentence_encoder_buckets_match_jax(models, n):
    port, jmodel, jvars = models
    rng = np.random.default_rng(n)
    texts = [" ".join(rng.choice(WORDS, int(rng.integers(1, 9)))) for _ in range(n)]
    got = minilm.MiniLMSentenceEncoder(port, _word_tokenize).encode(texts)
    want = jax_minilm.MiniLMSentenceEncoder(jmodel, jvars, _word_tokenize).encode(texts)
    assert got.shape == (n, 32) and got.dtype == np.float32
    assert_share(got, want, JAX_SHARE)
    assert minilm.MiniLMSentenceEncoder(port, _word_tokenize)._bucket(n) == (16 if n < 16 else 32)
    assert minilm.MiniLMSentenceEncoder(port, _word_tokenize).encode([]).shape == (0, 32)


@pytest.fixture(scope="module")
def minilm_dir(tmp_path_factory, hf_bert):
    from transformers import BertTokenizer

    d = tmp_path_factory.mktemp("minilm")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(set(WORDS))
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    BertTokenizer(vocab_file=str(d / "vocab.txt")).save_pretrained(d)
    hf_bert.save_pretrained(d)
    return str(d)


def test_load_hf_minilm_reads_the_directory(minilm_dir, hf_bert):
    cfg, state = minilm.load_hf_minilm(minilm_dir)
    assert cfg == minilm.MiniLMConfig.tiny()
    want = minilm.convert_hf_bert(hf_bert.state_dict(), cfg)
    assert state.keys() == want.keys()
    assert all(torch.equal(state[k], want[k]) for k in want)


def test_make_embedder_minilm_rung_matches_jax(minilm_dir):
    from gvl_tpu.agent.config import ReasoningCoreConfig as JaxCoreConfig
    from gvl_tpu.agent.retriever import make_embedder as jax_make_embedder
    from gvl_tpu_torch.agent.config import ReasoningCoreConfig
    from gvl_tpu_torch.agent.retriever import make_embedder

    got_emb = make_embedder(ReasoningCoreConfig(embedding_model=minilm_dir), device="cpu")
    want_emb = jax_make_embedder(JaxCoreConfig(embedding_model=minilm_dir))
    assert isinstance(got_emb, minilm.MiniLMSentenceEncoder)
    assert isinstance(want_emb, jax_minilm.MiniLMSentenceEncoder)
    texts = ["the boss appears at the gate", "player health is low", "an item drops",
             "enemy defeated near the bridge"]
    got, want = got_emb.encode(texts), want_emb.encode(texts)
    assert got.shape == (4, 32)
    assert_share(got, want, JAX_SHARE)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_c15_unloadable_minilm_dir_raises_where_jax_falls_through(tmp_path, monkeypatch):
    """C15: JAX's rung catches the failed load and falls through
    (sentence-transformers, then hashing); the port refuses the directory."""
    from gvl_tpu.agent.config import ReasoningCoreConfig as JaxCoreConfig
    from gvl_tpu.agent.retriever import HashingTextEmbedder as JaxHashing
    from gvl_tpu.agent.retriever import make_embedder as jax_make_embedder
    from gvl_tpu_torch.agent.config import ReasoningCoreConfig
    from gvl_tpu_torch.agent.retriever import make_embedder

    bad = tmp_path / "not_minilm"
    bad.mkdir()
    (bad / "config.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "sentence_transformers", None)   # no second rung
    assert isinstance(jax_make_embedder(JaxCoreConfig(embedding_model=str(bad))), JaxHashing)
    with pytest.raises(ValueError, match="C15"):
        make_embedder(ReasoningCoreConfig(embedding_model=str(bad)), device="cpu")
