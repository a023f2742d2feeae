"""gvl_tpu_torch's chat session and speculative engines against gvl_tpu's,
on the CPU.

Weights made by the JAX model are carried across with ``params_from_jax``;
both sides run greedy with an f32 cache, where the chunk and single-token
forwards give equal logits, so token streams must be equal.  Stochastic
speculation cannot reproduce ``jax.random``'s bits; it is held to valid
tokens and to the target's distribution instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models.qwen3 import Qwen3Config as JaxConfig
from gvl_tpu.models.qwen3 import Qwen3Engine as JaxEngine
from gvl_tpu.models.qwen3 import Qwen3Model as JaxModel
from gvl_tpu.models.session import Qwen3ChatSession as JaxSession
from gvl_tpu.models.speculative import PromptLookupEngine as JaxLookup
from gvl_tpu.models.speculative import SpeculativeEngine as JaxSpeculative
from gvl_tpu_torch.models import qwen3 as port
from gvl_tpu_torch.models.convert import params_from_jax
from gvl_tpu_torch.models.session import Qwen3ChatSession
from gvl_tpu_torch.models.speculative import PromptLookupEngine, SpeculativeEngine

TURN1 = [7, 3, 99, 150, 2, 41]
TURN2 = [11, 12, 13]
TURN3 = [200, 201, 202, 203, 204]
PROMPT = [7, 3, 99, 12]
F32 = dict(dtype=torch.float32, device="cpu")


def _model(seed: int, **kw):
    jcfg, tcfg = JaxConfig.tiny(**kw), port.Qwen3Config.tiny(**kw)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    params = {"params": params["params"]}
    return jcfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray, params), tcfg)


@pytest.fixture(scope="module")
def tiny():
    return _model(0)


@pytest.fixture(scope="module")
def spec_models():
    return _model(0, num_layers=4), _model(7, num_layers=2)


def _port_greedy(tcfg, state, ids, n, eos=-1):
    return port.Qwen3Engine(tcfg, state, eos_token_id=eos, **F32).generate(
        ids, max_new_tokens=n, temperature=0.0)


# ------------------------------------------------------------------ session

def test_session_three_turns_match_jax_and_a_fresh_engine(tiny):
    jcfg, tcfg, params, state = tiny
    jax_session = JaxSession(jcfg, params, eos_token_id=-1, dtype=jnp.float32)
    session = Qwen3ChatSession(tcfg, state, eos_token_id=-1, **F32)
    transcript = []
    for turn in (TURN1, TURN2, TURN3):
        transcript = transcript + turn
        want = jax_session.generate(transcript, max_new_tokens=5, temperature=0.0)
        got = session.generate(transcript, max_new_tokens=5, temperature=0.0)
        assert got == want == _port_greedy(tcfg, state, transcript, 5)
        assert session.last_ingested == jax_session.last_ingested
        transcript = transcript + got
    # turns 2 and 3 ingested only their new turns: every answer token was
    # fed to the cache as it was generated
    assert session.last_ingested == len(TURN3)
    assert session.cache.length == len(transcript)


def test_session_divergent_prompt_and_reasked_transcript(tiny):
    jcfg, tcfg, params, state = tiny
    session = Qwen3ChatSession(tcfg, state, eos_token_id=-1, **F32)
    jax_session = JaxSession(jcfg, params, eos_token_id=-1, dtype=jnp.float32)
    first = session.generate(TURN1, max_new_tokens=4, temperature=0.0)
    assert first == jax_session.generate(TURN1, max_new_tokens=4, temperature=0.0)
    other = [100, 101, 102, 103]             # not an extension of TURN1
    got = session.generate(other, max_new_tokens=4, temperature=0.0)
    assert got == jax_session.generate(other, max_new_tokens=4, temperature=0.0)
    assert got == _port_greedy(tcfg, state, other, 4)
    assert session.last_ingested == len(other)
    # the cached transcript exactly: only its final token is fed again
    transcript = other + got
    again = session.generate(transcript, max_new_tokens=3, temperature=0.0)
    assert session.last_ingested == 1
    assert again == jax_session.generate(transcript, max_new_tokens=3,
                                         temperature=0.0)
    assert again == _port_greedy(tcfg, state, transcript, 3)


def test_session_eos_and_capacity_guard(tiny):
    _, tcfg, _, state = tiny
    expected = _port_greedy(tcfg, state, TURN1, 8)
    eos = expected[3]
    session = Qwen3ChatSession(tcfg, state, eos_token_id=eos, **F32)
    out = session.generate(TURN1, max_new_tokens=8, temperature=0.0)
    assert out == expected[:expected.index(eos)]
    transcript = TURN1 + out + TURN2
    assert (session.generate(transcript, max_new_tokens=3, temperature=0.0)
            == _port_greedy(tcfg, state, transcript, 3, eos))
    with pytest.raises(ValueError):
        session.generate(list(range(100)), max_new_tokens=100)


def _transcript_of(session, tcfg, state, cached: int, delta: int):
    """A first turn that leaves ``cached`` tokens in the session, then the
    transcript extended by ``delta`` new tokens."""
    first = list(np.random.default_rng(cached).integers(0, 512, cached - 8))
    out = session.generate(first, max_new_tokens=8, temperature=0.0)
    assert len(out) == 8 and session.cache.length == cached
    return first + out + list(range(300, 300 + delta))


@pytest.mark.parametrize("cached,fits", [(104, False), (60, True)])
def test_session_delta_bucket_overflow_starts_over(tiny, cached, fits):
    """104 cached + 17 new tokens on a 128-row cache: the delta's bucket of 32
    would run past the cache, so the session ingests the whole prompt from
    offset 0 and equals a fresh engine.  JAX's session clamps that write
    onto the cached prefix (ROADMAP C), so it is compared only where the
    bucket fits."""
    jcfg, tcfg, params, state = tiny
    session = Qwen3ChatSession(tcfg, state, eos_token_id=-1, **F32)
    transcript = _transcript_of(session, tcfg, state, cached, 17)
    got = session.generate(transcript, max_new_tokens=2, temperature=0.0)
    assert got == _port_greedy(tcfg, state, transcript, 2)
    assert session.last_ingested == (17 if fits else len(transcript))
    if fits:
        jax_session = JaxSession(jcfg, params, eos_token_id=-1, dtype=jnp.float32)
        first = transcript[:cached - 8]
        jax_session.generate(first, max_new_tokens=8, temperature=0.0)
        assert jax_session.generate(transcript, max_new_tokens=2,
                                    temperature=0.0) == got


# -------------------------------------------------------------- speculative

@pytest.mark.parametrize("gamma", [1, 2, 3, 4])
def test_speculative_greedy_is_the_target_greedy(spec_models, gamma):
    (jt_cfg, t_cfg, t_params, t_state), (jd_cfg, d_cfg, d_params, d_state) = spec_models
    want = _port_greedy(t_cfg, t_state, PROMPT, 12)
    engine = SpeculativeEngine(t_cfg, t_state, d_cfg, d_state, gamma=gamma,
                               eos_token_id=-1, **F32)
    assert engine.generate(PROMPT, max_new_tokens=12, temperature=0.0) == want
    lookup = PromptLookupEngine(t_cfg, t_state, gamma=gamma, ngram=3,
                                eos_token_id=-1, **F32)
    assert lookup.generate(PROMPT, max_new_tokens=12, temperature=0.0) == want
    if gamma == 4:
        jax_engine = JaxSpeculative(jt_cfg, t_params, jd_cfg, d_params, gamma=4,
                                    eos_token_id=-1, dtype=jnp.float32)
        assert jax_engine.generate(PROMPT, max_new_tokens=12, temperature=0.0) == want
        assert engine.last_stats == jax_engine.last_stats
        assert want == JaxEngine(jt_cfg, t_params, eos_token_id=-1,
                                 dtype=jnp.float32).generate(
            PROMPT, max_new_tokens=12, temperature=0.0)


def test_prompt_lookup_matches_jax(spec_models):
    (jt_cfg, t_cfg, t_params, t_state), _ = spec_models
    base = _port_greedy(t_cfg, t_state, PROMPT, 8)
    prompt = PROMPT + base + PROMPT          # a transcript that repeats
    lookup = PromptLookupEngine(t_cfg, t_state, gamma=4, ngram=4,
                                eos_token_id=-1, **F32)
    jax_lookup = JaxLookup(jt_cfg, t_params, gamma=4, ngram=4, eos_token_id=-1,
                           dtype=jnp.float32)
    got = lookup.generate(prompt, max_new_tokens=8, temperature=0.0)
    assert got == jax_lookup.generate(prompt, max_new_tokens=8, temperature=0.0)
    assert lookup.last_stats == jax_lookup.last_stats
    for committed in ([5, 10, 11, 12, 90, 91, 92, 93, 7, 10, 11, 12], [4, 9, 4],
                      [1, 2, 3]):
        assert lookup._ngram_draft(committed) == jax_lookup._ngram_draft(committed)


def test_speculative_stochastic_tokens_are_valid(spec_models):
    (_, t_cfg, _, t_state), (_, d_cfg, _, d_state) = spec_models
    gen = torch.Generator().manual_seed(5)
    engine = SpeculativeEngine(t_cfg, t_state, d_cfg, d_state, gamma=3,
                               eos_token_id=-1, **F32)
    out = engine.generate(PROMPT, max_new_tokens=10, temperature=0.9,
                          generator=gen)
    lookup = PromptLookupEngine(t_cfg, t_state, gamma=3, ngram=2,
                                eos_token_id=-1, **F32)
    out2 = lookup.generate(PROMPT, max_new_tokens=10, temperature=0.9,
                           generator=gen)
    for tokens in (out, out2):
        assert len(tokens) == 10 and all(0 <= t < 512 for t in tokens)
    # identical draft and target: p == q, so every proposal is accepted
    same = SpeculativeEngine(t_cfg, t_state, t_cfg, t_state, gamma=3,
                             eos_token_id=-1, **F32)
    same.generate(PROMPT, max_new_tokens=10, temperature=0.9, generator=gen)
    assert same.last_stats["acceptance_rate"] == 1.0


def test_speculative_sampling_follows_the_target_distribution():
    """The rejection rule's promise: the first verified token is distributed
    as the target's own sample.  On an 8-token vocabulary with peaked random
    weights, 600 seeded runs of [first token, second token] are compared
    with the target's exact joint distribution."""
    cfg = port.Qwen3Config.tiny(vocab_size=8, num_layers=1, max_cache_length=32)
    states = []
    for seed in (1, 2):
        state = port.init_params(cfg, torch.Generator().manual_seed(seed),
                                 dtype=torch.float32, device="cpu")
        states.append({k: v if k.endswith("norm.weight") else 40 * v
                       for k, v in state.items()})
    target, draft = states
    prompt, temperature = [1, 2, 3], 1.0
    model = port.load_model(cfg, target, "cpu")
    with torch.no_grad():
        p1 = torch.softmax(model(torch.tensor([prompt]))[0][0, -1], -1)
        joint = torch.stack([
            p1[a] * torch.softmax(model(torch.tensor([prompt + [a]]))[0][0, -1], -1)
            for a in range(8)])                           # [first, second]
    engine = SpeculativeEngine(cfg, target, cfg, draft, gamma=2,
                               eos_token_id=-1, **F32)
    counts = torch.zeros(8, 8)
    gen = torch.Generator().manual_seed(0)
    runs = 600
    for _ in range(runs):
        a, b = engine.generate(prompt, max_new_tokens=2, temperature=temperature,
                               generator=gen)
        counts[a, b] += 1
    assert engine.last_stats["acceptance_rate"] < 1.0       # q differs from p
    tv = 0.5 * (counts / runs - joint).abs().sum().item()
    # sampling noise of 600 draws over the cells with mass: TV ~0.05-0.08
    assert tv < 0.12, (tv, joint, counts / runs)


def test_speculative_streams_end_with_eos_as_jax(spec_models):
    """Both speculative engines yield the EOS token that ends a stream, as
    the JAX package's do (Qwen3Engine stops before it)."""
    (jt_cfg, t_cfg, t_params, t_state), (jd_cfg, d_cfg, d_params, d_state) = spec_models
    greedy = _port_greedy(t_cfg, t_state, PROMPT, 12)
    eos = greedy[5]
    want = greedy[:greedy.index(eos)] + [eos]
    engine = SpeculativeEngine(t_cfg, t_state, d_cfg, d_state, gamma=3,
                               eos_token_id=eos, **F32)
    jax_engine = JaxSpeculative(jt_cfg, t_params, jd_cfg, d_params, gamma=3,
                                eos_token_id=eos, dtype=jnp.float32)
    got = engine.generate(PROMPT, max_new_tokens=12, temperature=0.0)
    assert got == want == jax_engine.generate(PROMPT, max_new_tokens=12,
                                              temperature=0.0)
    lookup = PromptLookupEngine(t_cfg, t_state, gamma=3, eos_token_id=eos, **F32)
    assert lookup.generate(PROMPT, max_new_tokens=12, temperature=0.0) == want


# ------------------------------------------------------------- cache end

def _cache_end_models():
    return _model(0, num_layers=4)


def test_engine_stream_ends_cleanly_at_the_cache_end():
    """120 prompt tokens + 20 asked for on a 128-row cache: the port yields
    the 9 tokens that fit, equal to JAX's first 9, and does not raise.
    JAX's tokens 10-20 come from writes clamped onto the last cache row."""
    jcfg, tcfg, params, state = _cache_end_models()
    prompt = np.random.default_rng(3).integers(1, 500, 120).tolist()
    want = JaxEngine(jcfg, params, eos_token_id=-1, dtype=jnp.float32).generate(
        prompt, max_new_tokens=20, temperature=0.0)
    got = _port_greedy(tcfg, state, prompt, 20)
    assert len(want) == 20
    assert len(got) == tcfg.max_cache_length - len(prompt) + 1 == 9
    assert got == want[:9]


def test_chat_backend_stream_ends_cleanly_at_the_cache_end():
    """The same through Qwen3ChatBackend: with max_new_tokens above half
    the cache the backend keeps limit // 2 prompt tokens, so prompt +
    answer pass the cache; the stream ends where the cache does."""
    from gvl_tpu_torch.agent.config import ReasoningCoreConfig
    from gvl_tpu_torch.agent.core import Qwen3ChatBackend
    from gvl_tpu_torch.models.byte_tokenizer import ByteTokenizer

    jcfg, tcfg, params, state = _cache_end_models()
    engine = port.Qwen3Engine(tcfg, state, eos_token_id=-1, **F32)
    seen = {}

    class Recording:
        config = engine.config

        def stream(self, ids, **kw):
            seen["ids"], seen["tokens"] = list(ids), []
            for token in engine.stream(ids, **kw):
                seen["tokens"].append(token)
                yield token

    messages = [{"role": "user", "content": "".join(
        f"[{i:02d}:00] enemy detected\n" for i in range(12))}]
    backend = Qwen3ChatBackend(Recording(), ByteTokenizer())
    list(backend.stream(messages, ReasoningCoreConfig(max_new_tokens=100,
                                                   temperature=0.0)))
    assert len(seen["ids"]) == tcfg.max_cache_length // 2
    want = JaxEngine(jcfg, params, eos_token_id=-1, dtype=jnp.float32).generate(
        seen["ids"], max_new_tokens=100, temperature=0.0)
    n_fit = tcfg.max_cache_length - len(seen["ids"]) + 1
    assert len(seen["tokens"]) == n_fit and seen["tokens"] == want[:n_fit]


def test_speculative_gamma_1_at_the_cache_end_accepts_every_draft():
    """Draft = target, gamma 1, 100 + 26 tokens on a 128-row cache: the
    port pads its catch-up chunk only up to the cache end, so it accepts
    every draft (JAX accepts 12 of 14: its padded catch-up write clamps
    onto cached draft rows).  Tokens equal JAX's and the target's greedy
    decode."""
    jcfg, tcfg, params, state = _model(0, num_layers=2)
    prompt = np.random.default_rng(0).integers(1, 500, 100).tolist()
    engine = SpeculativeEngine(tcfg, state, tcfg, state, gamma=1,
                               eos_token_id=-1, **F32)
    got = engine.generate(prompt, max_new_tokens=26, temperature=0.0)
    jax_engine = JaxSpeculative(jcfg, params, jcfg, params, gamma=1,
                                eos_token_id=-1, dtype=jnp.float32)
    want = jax_engine.generate(prompt, max_new_tokens=26, temperature=0.0)
    assert got == want == _port_greedy(tcfg, state, prompt, 26)
    assert len(got) == 26
    stats = engine.last_stats
    assert stats["drafted"] > 0 and stats["accepted"] == stats["drafted"]
    assert stats["acceptance_rate"] == 1.0
