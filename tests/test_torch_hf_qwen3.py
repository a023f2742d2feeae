"""The HF Qwen3 branch of gvl_tpu_torch against gvl_tpu's, on the CPU.

A tiny random ``Qwen3ForCausalLM`` (the geometry of ``tests/test_qwen3.py``)
is saved with a ``PreTrainedTokenizerFast`` built offline with
``tokenizers`` (byte-level BPE, ChatML specials and template).  Both
packages load the directory: ``convert_hf_qwen3`` (unrolled and
``scan_layers``), ``load_hf_qwen3``, ``create_reasoning_core(
checkpoint_path=)`` with its session, speculative and prompt-lookup
engines, and ``deploy_api --llm-checkpoint`` (with and without
``--int8``) over ``/generate``.  Answers are compared at temperature 0 on
each package's default bf16 caches.

The helpers here (``offline_tokenizer``, ``save_tiny_qwen3``,
``save_tiny_qwen3vl``) are shared with the other files that load HF
directories.
"""

import os

os.environ.setdefault("USE_TF", "0")   # transformers need not import TensorFlow (5 s)

import http.client  # noqa: E402
import json  # noqa: E402
import threading  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gvl_tpu.agent import ReasoningCoreConfig as JaxCoreConfig  # noqa: E402
from gvl_tpu.agent.core import create_reasoning_core as jax_create_core  # noqa: E402
from gvl_tpu.fusion import ModalityType as JaxModality  # noqa: E402
from gvl_tpu.fusion import TimelineIndexer as JaxTimeline  # noqa: E402
from gvl_tpu.models.qwen3 import Qwen3Config as JaxConfig  # noqa: E402
from gvl_tpu.models.qwen3 import convert_hf_qwen3 as jax_convert  # noqa: E402
from gvl_tpu.models.qwen3 import load_hf_qwen3 as jax_load  # noqa: E402
from gvl_tpu_torch.agent import ReasoningCoreConfig  # noqa: E402
from gvl_tpu_torch.agent import core as tcore  # noqa: E402
from gvl_tpu_torch.fusion import ModalityType, TimelineIndexer  # noqa: E402
from gvl_tpu_torch.models import qwen3 as port  # noqa: E402
from gvl_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gvl_tpu_torch.scripts import deploy_api  # noqa: E402

LOGITS_ATOL = 1e-4
CHATML = ("{% for m in messages %}<|im_start|>{{ m['role'] }}\n{{ m['content'] }}"
          "<|im_end|>\n{% endfor %}{% if add_generation_prompt %}<|im_start|>assistant\n"
          "{% endif %}")
# ids 0-9: specials, so that no text byte lands on Qwen3-VL's tiny image
# and vision-span ids (5, 6, 7, 8 in tests/test_qwen3vl.py)
SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|s3|>", "<|s4|>",
            "<|vision_start|>", "<|vision_end|>", "<|image_pad|>", "<|video_pad|>", "<|s9|>"]
CORPUS = ["the boss appears at the gate", "player health is low", "an item drops",
          "what happens at 00:12?", "Answer from the timeline.", "enemy defeated"] * 8
SYSTEM = "You are a gameplay video analyst. Answer from the timeline."
QUESTIONS = ("When does the boss appear?", "What drops after the fight?")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def offline_tokenizer():
    """A byte-level BPE tokenizer of 300 ids (ids 0-9 special, EOS
    ``<|im_end|>`` = 2) with the Qwen ChatML template, built without a
    download."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=300, special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<|im_end|>",
                                   pad_token="<|endoftext|>")
    fast.chat_template = CHATML
    return fast


def tiny_hf_qwen3(seed=0, layers=2):
    from transformers import Qwen3Config as HFConfig
    from transformers import Qwen3ForCausalLM

    cfg = HFConfig(hidden_size=64, num_hidden_layers=layers, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=16, intermediate_size=128,
                   vocab_size=512, max_position_embeddings=256, rope_theta=10000.0,
                   tie_word_embeddings=False)
    torch.manual_seed(seed)
    return Qwen3ForCausalLM(cfg).eval()


def save_tiny_qwen3(path, seed=0, layers=2, tokenizer=True):
    """A tiny HF Qwen3 checkpoint directory (with the offline tokenizer)."""
    tiny_hf_qwen3(seed, layers).save_pretrained(path)
    if tokenizer:
        offline_tokenizer().save_pretrained(path)
    return path


def save_tiny_qwen3vl(path):
    """JAX's tiny HF Qwen3-VL pair (``tests/test_qwen3vl.py``) as a
    checkpoint directory with the offline tokenizer."""
    from test_qwen3vl import tiny_hf_model

    tiny_hf_model().save_pretrained(path)
    offline_tokenizer().save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf_qwen3")
    return {"target": save_tiny_qwen3(root / "target"),
            "draft": save_tiny_qwen3(root / "draft", seed=1, layers=1),
            "weights_only": save_tiny_qwen3(root / "weights_only", tokenizer=False)}


@pytest.mark.parametrize("scan", [False, True])
def test_convert_hf_qwen3_matches_jax(scan):
    """Key for key the port's tensors of JAX's converted tree, and the
    logits of HF's model within LOGITS_ATOL (the stacked model too)."""
    hf = tiny_hf_qwen3()
    jcfg = JaxConfig.tiny(rope_theta=10000.0, scan_layers=scan)
    tcfg = port.Qwen3Config.tiny(rope_theta=10000.0, scan_layers=scan)
    want = params_from_jax(jax.tree.map(np.asarray, jax_convert(hf.state_dict(), jcfg)), tcfg)
    got = port.convert_hf_qwen3(hf.state_dict(), tcfg)
    assert got.keys() == want.keys()
    for key in got:
        assert torch.equal(got[key], want[key]), key
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 11)))
    with torch.no_grad():
        ref = hf(input_ids=tokens).logits
        logits, _ = port.load_model(tcfg, got, "cpu")(tokens)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=LOGITS_ATOL)


def test_load_hf_qwen3_matches_jax(hf_dirs):
    """The saved directory: the port's (config, state) against JAX's
    (model, variables); the config's every JAX field equal."""
    tcfg, state = port.load_hf_qwen3(hf_dirs["target"])
    jmodel, variables = jax_load(str(hf_dirs["target"]))
    assert {f: getattr(tcfg, f) for f in jmodel.config.__dataclass_fields__} == \
        jmodel.config.__dict__
    want = params_from_jax(jax.tree.map(np.asarray, variables), tcfg)
    assert state.keys() == want.keys()
    assert all(torch.equal(state[k], want[k]) for k in state)


def test_load_hf_qwen3_needs_transformers(hf_dirs, monkeypatch):
    """``transformers`` is imported inside the loader: without it the
    ImportError propagates (no fake model)."""
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        port.load_hf_qwen3(hf_dirs["target"])


def _timelines():
    jt, tt = JaxTimeline(), TimelineIndexer()
    for ts, text in ((12.0, "boss appears at the gate"), (40.0, "an item drops"),
                     (41.0, "enemy defeated")):
        jt.add_event(ts, JaxModality.VISUAL, text)
        tt.add_event(ts, ModalityType.VISUAL, text)
    return jt, tt


def _answers(core, timeline, questions=QUESTIONS):
    return [core.reason(q, timeline_indexer=timeline) for q in questions]


@pytest.mark.parametrize("engine", ["session", "draft", "prompt_lookup"])
def test_create_reasoning_core_hf_engines_match_jax(hf_dirs, engine):
    """``create_reasoning_core(checkpoint_path=<HF dir>)``: the session
    engine (two turns, the second prefilling the delta), the speculative
    engine over the 1-layer draft, and prompt lookup; answers equal to
    JAX's at temperature 0."""
    kw = {"draft": {"draft_checkpoint_path": str(hf_dirs["draft"]), "speculative_gamma": 3},
          "prompt_lookup": {"use_prompt_lookup": True}}.get(engine, {})
    common = dict(embedding_model="hashing", temperature=0.0, max_new_tokens=8,
                  system_prompt=SYSTEM)
    want_core = jax_create_core(JaxCoreConfig(**common), checkpoint_path=str(hf_dirs["target"]),
                                **kw)
    got_core = tcore.create_reasoning_core(ReasoningCoreConfig(**common),
                                           checkpoint_path=str(hf_dirs["target"]),
                                           device="cpu", **kw)
    backend = got_core.backend
    assert isinstance(backend, tcore.Qwen3ChatBackend)
    assert (backend.session is not None) == (engine == "session")
    assert (backend.spec_engine is not None) == (engine != "session")
    if engine == "draft":
        assert backend.spec_engine.draft_config.num_layers == 1
    jt, tt = _timelines()
    want, got = _answers(want_core, jt), _answers(got_core, tt)
    assert got == want
    assert any(got)


def test_hf_lora_adapter_merges_like_jax(hf_dirs, tmp_path):
    """A LoRA adapter in the repository's layout (every ``lora_b`` non-zero)
    merged into the HF base through ``create_reasoning_core(lora_path=)``:
    the same answers as JAX's, and not the base's."""
    rng = np.random.default_rng(3)
    flat = {}
    for i in range(2):
        for name, (n_in, n_out) in (("self_attn/q_proj", (64, 64)),
                                    ("mlp/down_proj", (128, 64))):
            flat[f"layers_{i}/{name}/lora_a"] = rng.normal(0, 0.5, (n_in, 4)).astype(np.float32)
            flat[f"layers_{i}/{name}/lora_b"] = rng.normal(0, 0.5, (4, n_out)).astype(np.float32)
    np.savez(tmp_path / "adapter_final.npz", **flat)
    (tmp_path / "adapter_config.json").write_text(json.dumps(
        {"lora_rank": 4, "lora_alpha": 8.0, "targets": ["q_proj", "down_proj"]}))
    common = dict(embedding_model="hashing", temperature=0.0, max_new_tokens=8,
                  system_prompt=SYSTEM)
    cores = [jax_create_core(JaxCoreConfig(**common), checkpoint_path=str(hf_dirs["target"]),
                             lora_path=str(tmp_path)),
             tcore.create_reasoning_core(ReasoningCoreConfig(**common),
                                         checkpoint_path=str(hf_dirs["target"]),
                                         lora_path=str(tmp_path), device="cpu"),
             tcore.create_reasoning_core(ReasoningCoreConfig(**common),
                                         checkpoint_path=str(hf_dirs["target"]), device="cpu")]
    jt, tt = _timelines()
    want, got, base = (_answers(core, t, QUESTIONS[:1])
                       for core, t in zip(cores, (jt, tt, tt)))
    assert got == want and got != base



# C12: adapters that do not fit the tiny HF base (hidden 64, MLP 128, 2
# layers): (adapter_config.json, npz tensor shapes)
_MISFITS = {
    "input_width": ({"lora_rank": 4, "lora_alpha": 8.0, "targets": ["q_proj"]},
                    {"layers_0/self_attn/q_proj/lora_a": (32, 4),
                     "layers_0/self_attn/q_proj/lora_b": (4, 64)}),
    "rank": ({"lora_rank": 8, "lora_alpha": 8.0, "targets": ["q_proj"]},
             {"layers_0/self_attn/q_proj/lora_a": (64, 4),
              "layers_0/self_attn/q_proj/lora_b": (4, 64)}),
    "target": ({"lora_rank": 4, "lora_alpha": 8.0, "targets": ["down_proj"]},
               {"layers_1/mlp/down_proj/lora_a": (64, 4),
                "layers_1/mlp/down_proj/lora_b": (4, 64)}),
    "no_rank": ({"lora_alpha": 8.0, "targets": ["q_proj"]},
                {"layers_0/self_attn/q_proj/lora_a": (64, 4),
                 "layers_0/self_attn/q_proj/lora_b": (4, 64)}),
}


def _raised(call):
    """(exception, names of the package's frames from the factory down)."""
    import traceback

    with pytest.raises(Exception) as info:
        call()
    frames = [f for f in traceback.extract_tb(info.value.__traceback__)
              if "gvl_tpu" in f.filename]
    return info.value, frames


@pytest.mark.parametrize("misfit", sorted(_MISFITS))
def test_c12_a_misfit_adapter_raises_as_jax_does(hf_dirs, tmp_path, misfit):
    """ROADMAP C12: an adapter whose shapes, rank or targets do not fit the
    HF base (or whose config lacks its rank) makes both packages' factories
    raise the same exception, with the same message, in the same step: the
    merge (``load_adapter_and_merge`` of ``models/qwen3.py``), before the
    tokenizer or any engine is built."""
    meta, shapes = _MISFITS[misfit]
    rng = np.random.default_rng(12)
    np.savez(tmp_path / "adapter_final.npz",
             **{k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in shapes.items()})
    (tmp_path / "adapter_config.json").write_text(json.dumps(meta))
    common = dict(embedding_model="hashing", temperature=0.0, max_new_tokens=8)
    want, want_frames = _raised(lambda: jax_create_core(
        JaxCoreConfig(**common), checkpoint_path=str(hf_dirs["target"]),
        lora_path=str(tmp_path)))
    got, got_frames = _raised(lambda: tcore.create_reasoning_core(
        ReasoningCoreConfig(**common), checkpoint_path=str(hf_dirs["target"]),
        lora_path=str(tmp_path), device="cpu"))
    assert type(got) is type(want) and type(want) in (ValueError, KeyError)
    assert str(got) == str(want)

    def step(frames):
        return next(f.name for f in frames if f.filename.endswith("models/qwen3.py"))

    assert step(got_frames) == step(want_frames) == "load_adapter_and_merge"
    factory = {"create_reasoning_core", "create_hf_backend"}
    for frames in (got_frames, want_frames):
        assert frames[0].name == "create_reasoning_core"
        assert all(f.name in factory for f in frames[:frames.index(
            next(f for f in frames if f.filename.endswith("models/qwen3.py")))])


def test_c12_an_adapter_of_unknown_targets_adds_nothing_in_both(hf_dirs, tmp_path):
    """An adapter whose targets name no layer of the base: neither factory
    raises, and both answer as their base does (JAX's behaviour, kept)."""
    np.savez(tmp_path / "adapter_final.npz",
             **{"layers_0/self_attn/w_proj/lora_a": np.ones((64, 4), np.float32),
                "layers_0/self_attn/w_proj/lora_b": np.ones((4, 64), np.float32)})
    (tmp_path / "adapter_config.json").write_text(json.dumps(
        {"lora_rank": 4, "lora_alpha": 8.0, "targets": ["w_proj"]}))
    common = dict(embedding_model="hashing", temperature=0.0, max_new_tokens=8,
                  system_prompt=SYSTEM)
    jax_core = jax_create_core(JaxCoreConfig(**common), checkpoint_path=str(hf_dirs["target"]),
                               lora_path=str(tmp_path))
    cores = [tcore.create_reasoning_core(ReasoningCoreConfig(**common),
                                         checkpoint_path=str(hf_dirs["target"]),
                                         lora_path=lora, device="cpu")
             for lora in (str(tmp_path), None)]
    jt, tt = _timelines()
    want = _answers(jax_core, jt, QUESTIONS[:1])
    got, base = (_answers(core, tt, QUESTIONS[:1]) for core in cores)
    assert got == want == base

def _request(port_no, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port_no, timeout=120)
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read() or b"{}")
    conn.close()
    return resp.status, data


def _jax_generate(checkpoint, int8, bodies):
    """JAX's ``scripts/deploy_api._attach_llm`` on its service, then each
    body through the service's ``/generate`` handler."""
    from gvl_tpu.config import load_preset
    from gvl_tpu.serving import create_server

    from scripts import deploy_api as jdeploy

    server = create_server("127.0.0.1", 0, load_preset("light"))
    try:
        jdeploy._attach_llm(server.service, str(checkpoint), 2, int8=int8)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        out = [_request(server.server_address[1], "/generate", b) for b in bodies]
    finally:
        engine_server = server.service._engine_server
        if hasattr(engine_server, "shutdown"):
            engine_server.shutdown()
        server.shutdown()
        server.server_close()
    return out


@pytest.mark.parametrize("int8", [False, True])
def test_deploy_api_hf_checkpoint_generates_like_jax(hf_dirs, int8):
    """``deploy_api --llm-checkpoint <HF dir>`` (``--int8``): string and
    id prompts over ``/generate``, tokens equal to JAX's script's; a
    weights-only directory serves ``prompt_ids`` only, EOS 151645."""
    bodies = [{"prompt": "what happens at 00:12?", "max_new_tokens": 6},
              {"prompt_ids": [11, 40, 12, 99, 250], "max_new_tokens": 6}]
    want = _jax_generate(hf_dirs["target"], int8, bodies)
    argv = ["--port", "0", "--device", "cpu", "--llm-checkpoint", str(hf_dirs["target"]),
            "--num-slots", "2"] + (["--int8"] if int8 else [])
    server = deploy_api.build_server(argv)
    engine_server = server.service._engine_server
    assert engine_server.engine.config.quant_int8 == int8
    assert engine_server.engine.eos_token_id == 2
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        got = [_request(server.server_address[1], "/generate", b) for b in bodies]
    finally:
        if hasattr(engine_server, "shutdown"):
            engine_server.shutdown()
        server.shutdown()
        server.server_close()
    assert [s for s, _ in got] == [200, 200] == [s for s, _ in want]
    assert [g["tokens"] for _, g in got] == [w["tokens"] for _, w in want]
    assert [g.get("text") for _, g in got] == [w.get("text") for _, w in want]

    bare = deploy_api.build_server(["--port", "0", "--device", "cpu", "--llm-checkpoint",
                                    str(hf_dirs["weights_only"])])
    try:
        assert bare.service._tokenizer is None
        assert bare.service._engine_server.engine.eos_token_id == 151645
        with pytest.raises(ValueError, match="tokenizer"):
            bare.service._prompt_ids({"prompt": "hi"})
    finally:
        if hasattr(bare.service._engine_server, "shutdown"):
            bare.service._engine_server.shutdown()
        bare.server_close()
