"""gvl_tpu_torch QA-model serving against gvl_tpu's, on the CPU.

The procedural samples must be byte-identical for the same seed, the
held-out evaluation must give the same answer strings, and the chat
backend the same text, on the real ``outputs/qa_lm`` weights.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from gvl_tpu.agent.config import ReasoningCoreConfig
from gvl_tpu.agent.core import Qwen3ChatBackend as JaxBackend
from gvl_tpu.agent.core import messages_to_plain_text as jax_plain_text
from gvl_tpu.models.byte_tokenizer import ByteTokenizer as JaxByteTokenizer
from gvl_tpu.models.qwen3 import Qwen3Engine as JaxEngine
from gvl_tpu.training import qa_lm_train as jax_qa
from gvl_tpu_torch.agent import config as port_config
from gvl_tpu_torch.agent.core import (
    Qwen3ChatBackend,
    create_qa_backend,
    messages_to_plain_text,
)
from gvl_tpu_torch.models.byte_tokenizer import EOS_ID, ByteTokenizer
from gvl_tpu_torch.training import qa_lm_train as port_qa

QA_CKPT = Path(__file__).resolve().parents[1] / "outputs" / "qa_lm"


@pytest.mark.parametrize("family", [None, "binary", "mcq", "timestamp", "ocr",
                                    "audio", "causal"])
def test_samples_byte_identical(family):
    jrng, trng = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(12):
        want = jax_qa.generate_qa_sample(jrng, family=family)
        got = port_qa.generate_qa_sample(trng, family=family)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("short_system,serving", [(True, False), (False, True)])
def test_encoded_samples_identical(short_system, serving):
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    for max_len in (3072, 600):
        want = jax_qa.generate_qa_sample(jrng, serving_sections=serving,
                                         short_system=short_system)
        got = port_qa.generate_qa_sample(trng, serving_sections=serving,
                                         short_system=short_system)
        for a, b in zip(port_qa.encode_sample(got, ByteTokenizer(), max_len),
                        jax_qa.encode_sample(want, JaxByteTokenizer(), max_len)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert port_qa.render_chatml("s", "u", "a") == jax_qa.render_chatml("s", "u", "a")


def test_answer_scoring_identical():
    rng = np.random.default_rng(5)
    texts = ["**Answer:** B) enemy ([00:10])", "**Answer:** Yes ([01:02])",
             "**Answer:** [03:04]", "no answer", '**Answer:** "HP 12/40"']
    for _ in range(30):
        sample = port_qa.generate_qa_sample(rng)
        for text in texts + [sample.answer]:
            assert (port_qa._answer_correct(text, sample)
                    == jax_qa._answer_correct(text, sample))


def test_configs_and_tokenizer_match():
    want = dataclasses.asdict(jax_qa.qa_lm_config())
    got = dataclasses.asdict(port_qa.qa_lm_config())
    assert {k: got[k] for k in want} == want
    text = "héllo [00:12] **Answer:**"
    assert ByteTokenizer().encode(text) == JaxByteTokenizer().encode(text)
    ids = ByteTokenizer().encode(text) + [EOS_ID, 300]
    assert ByteTokenizer().decode(ids) == JaxByteTokenizer().decode(ids)


class _Recorder:
    """Engine proxy that keeps every generated token list."""

    def __init__(self, engine):
        self.engine, self.config, self.outputs = engine, engine.config, []

    def generate(self, ids, **kw):
        out = self.engine.generate(ids, **kw)
        self.outputs.append(out)
        return out


@pytest.fixture(scope="module")
def qa_models():
    jcfg, jparams = jax_qa.load_qa_lm(QA_CKPT)
    jax_engine = JaxEngine(jcfg, {"params": jparams}, eos_token_id=EOS_ID)
    return jax_engine, create_qa_backend(QA_CKPT, device="cpu")


def test_evaluate_qa_lm_same_answers(qa_models):
    jax_engine, backend = qa_models
    kw = dict(n_samples=2, seed=1234, max_new_tokens=16, short_system=True)
    recorder = _Recorder(jax_engine)
    want = jax_qa.evaluate_qa_lm(None, jax_engine.config, engine=recorder, **kw)
    got = port_qa.evaluate_qa_lm(engine=backend.engine, **kw)
    assert got["answers"] == [ByteTokenizer().decode(o) for o in recorder.outputs]
    assert got["accuracy"] == want["accuracy"]
    assert got["by_family"] == want["by_family"]


def test_chat_backend_stream_same_text(qa_models):
    jax_engine, backend = qa_models
    messages = [
        {"role": "system", "content": "sys"},
        {"role": "user", "content": [
            {"type": "text", "text": "## Timeline Context\n[00:31] enemy detected"},
            {"type": "image"},
            {"type": "text", "text": "## Question\nWhen is the enemy first "
                                     "detected?"}]},
    ]
    assert messages_to_plain_text(messages) == jax_plain_text(messages)
    want = list(JaxBackend(jax_engine, JaxByteTokenizer()).stream(
        messages, ReasoningCoreConfig(max_new_tokens=24, temperature=0.0)))
    got = list(backend.stream(messages, port_config.ReasoningCoreConfig(max_new_tokens=24,
                                                         temperature=0.0)))
    assert got == want and "".join(got)


class _FakeEngine:
    """Records the prompt a backend hands to its engine."""

    def __init__(self, max_cache_length=256, hidden_size=64):
        self.config = type("Cfg", (), {"max_cache_length": max_cache_length,
                                       "hidden_size": hidden_size})()
        self.prompts = []

    def stream(self, ids, **kw):
        self.prompts.append((list(ids), kw.get("inputs_embeds_prefix")))
        yield from ByteTokenizer().encode("**Answer:** é")


def test_backend_trims_and_drops_prefix_like_jax():
    long_user = "".join(f"[{i:02d}:00] enemy detected\n" for i in range(60))
    messages = [{"role": "system", "content": "sys"},
                {"role": "user", "content": long_user}]
    cfg = port_config.ReasoningCoreConfig(max_new_tokens=32, temperature=0.0)
    prefix = np.zeros((4, 32), np.float32)    # wrong width: dropped
    port_engine, jax_fake = _FakeEngine(), _FakeEngine()
    got = list(Qwen3ChatBackend(port_engine, ByteTokenizer()).stream(
        messages, cfg, inputs_embeds_prefix=prefix))
    want = list(JaxBackend(jax_fake, JaxByteTokenizer()).stream(
        messages, ReasoningCoreConfig(max_new_tokens=32, temperature=0.0),
        inputs_embeds_prefix=prefix))
    assert got == want
    assert port_engine.prompts[0][0] == jax_fake.prompts[0][0]
    assert len(port_engine.prompts[0][0]) == 256 - 32
    assert port_engine.prompts[0][1] is None


def test_entry_points_run_on_cpu_when_asked(qa_models):
    _, backend = qa_models
    assert backend.engine.device.type == "cpu"
    assert backend.engine.config.max_cache_length == 4608
    assert jnp.asarray(1).dtype == jnp.int32   # JAX stays on its CPU backend
