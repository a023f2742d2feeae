"""The decoder's LoRA and int8 options (``gvl_tpu_torch.models.qwen3``:
``Linear(quant=, rank=)``, ``merge_lora``, ``quantize_int8``,
``load_adapter_and_merge``; ``create_reasoning_core(lora_path=...)``)
against ``gvl_tpu.models.qwen3`` and ``gvl_tpu.agent.core``, on the CPU.

Tolerances: tiny-model logits in f32 within 1e-5 (LoRA and int8, 2
layers); ``quantize_int8``'s int8 tensors equal bit for bit and its scales
within one f32 ulp; merged QA weights within 1e-6; greedy answers of the
merged QA model equal token for token in f32.

The in-repository adapter ``outputs/lora_adapter`` was trained over an
older base (hidden 384, intermediate 1536; ``outputs/qa_lm`` is 640 /
2560): JAX's ``load_adapter_and_merge`` raises on it and its
``create_reasoning_core`` serves the base weights (ROADMAP C6).  The merge
itself is held to JAX on a seeded adapter written at the QA model's
geometry in the adapter's npz layout.
"""

import json
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.agent import core as jcore
from gvl_tpu.models import qwen3 as jq
from gvl_tpu.training.qa_lm_train import load_qa_lm as jax_load_qa_lm
from gvl_tpu_torch.agent import core as tcore
from gvl_tpu_torch.models import qwen3 as tq
from gvl_tpu_torch.models.convert import params_from_jax
from gvl_tpu_torch.training.qa_lm_train import load_qa_lm

LOGITS_ATOL = 1e-5
MERGED_ATOL = 1e-6
REPO = Path(__file__).resolve().parents[1]
QA_CKPT = REPO / "outputs" / "qa_lm"
ADAPTER = REPO / "outputs" / "lora_adapter"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tiny(seed: int = 0, **kw):
    """JAX's tiny model with ``kw``: LoRA's ``lora_b`` drawn non-zero, and
    an int8 model's kernels quantized from the float model's by JAX's
    ``quantize_int8`` (LoRA pairs kept beside the int8 bases)."""
    jcfg, tcfg = jq.Qwen3Config.tiny(**kw), tq.Qwen3Config.tiny(**kw)
    float_cfg = jq.Qwen3Config.tiny(**{**kw, "quant_int8": False})
    params = _np(jax.jit(jq.Qwen3Model(float_cfg).init)(jax.random.PRNGKey(seed),
                                                        jnp.ones((1, 8), jnp.int32)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if "lora_b" in jax.tree_util.keystr(path):
            return rng.normal(0, 0.05, leaf.shape).astype(leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(draw, params)
    if jcfg.quant_int8:     # rank 0 here: quantize the bases, keep the pairs
        params = {"params": _np(jq.quantize_int8(params["params"],
                                                 jq.Qwen3Config.tiny(**{**kw, "lora_rank": 0})))}
    return jcfg, tcfg, params


@pytest.mark.parametrize("option", [dict(lora_rank=4, lora_alpha=8.0),
                                    dict(lora_rank=4, lora_alpha=8.0, scan_layers=True),
                                    dict(quant_int8=True, scan_layers=True),
                                    dict(quant_int8=True, lora_rank=2,
                                         lora_targets=("q_proj", "down_proj"))],
                         ids=["lora", "lora_scan", "int8_scan", "int8_lora_two_targets"])
def test_tiny_logits_match(option):
    """Teacher-forced logits, then a cached prefill and 3 decode steps
    (a ``scan_layers`` model's through the stacked cache)."""
    jcfg, tcfg, params = _tiny(**option)
    state = params_from_jax(params, tcfg)
    if tcfg.quant_int8:
        assert state["lm_head.weight_q"].dtype == torch.int8
    tokens = np.random.default_rng(1).integers(0, 512, (2, 11)).astype(np.int32)
    apply = jax.jit(jq.Qwen3Model(jcfg).apply)      # one compile per shape
    want, _ = apply(params, jnp.asarray(tokens))
    model = tq.load_model(tcfg, state, "cpu")
    with torch.no_grad():
        got, _ = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)

    jcache = jq.KVCache.zeros(jcfg, 1, jnp.float32)
    jlogits, jcache = apply(params, jnp.asarray(tokens[:1]), cache=jcache)
    cache = tq.KVCache.zeros(tcfg, 1, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        tlogits, cache = model(torch.from_numpy(tokens[:1]).long(), cache=cache)
        for _ in range(3):
            np.testing.assert_allclose(tlogits[:, -1].numpy(), np.asarray(jlogits)[:, -1],
                                       atol=LOGITS_ATOL)
            token = int(np.argmax(np.asarray(jlogits)[0, -1]))
            jlogits, jcache = apply(params, jnp.asarray([[token]], jnp.int32),
                                    positions=jcache.length[None], cache=jcache)
            tlogits, cache = model(torch.tensor([[token]]),
                                   positions=torch.tensor([cache.length]), cache=cache)


@pytest.mark.parametrize("scan", [False, True])
def test_quantize_int8_equal(scan):
    """Per output channel (and per layer when stacked): int8 equal bit for
    bit, scales within one ulp; LoRA merged first (the quantized model's
    logits: ``test_tiny_logits_match``)."""
    jcfg, tcfg, params = _tiny(scan_layers=scan, lora_rank=4)
    jqparams = _np(jq.quantize_int8(params["params"], jcfg))
    qcfg_t = tq.Qwen3Config.tiny(scan_layers=scan, quant_int8=True)
    want = params_from_jax({"params": jqparams}, qcfg_t)
    got = tq.quantize_int8(params_from_jax(params, tcfg), tcfg)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype == torch.int8:
            assert torch.equal(g, w), name
        elif name.endswith(".scale"):
            ulp = np.spacing(np.abs(w.numpy()))
            assert (np.abs(g.numpy() - w.numpy()) <= ulp).all(), name
        else:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("targets", [None, ("k_proj", "up_proj")])
def test_merge_lora_equal(targets):
    kw = {"lora_targets": targets} if targets else {}
    jcfg, tcfg, params = _tiny(lora_rank=4, lora_alpha=16.0, **kw)
    want = params_from_jax({"params": _np(jq.merge_lora(params["params"], jcfg))},
                           tq.Qwen3Config.tiny())
    got = tq.merge_lora(params_from_jax(params, tcfg), tcfg)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=MERGED_ATOL)


def _write_adapter(root: Path, shapes: dict, rank=32, alpha=64.0, seed=5,
                   name="adapter_final.npz") -> Path:
    """A seeded adapter in the in-repository layout: ``adapter_config.json``
    and an npz of ``layers_{i}/<module>/<target>/lora_a|lora_b``."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    arrays = {k: rng.normal(0, 0.02, s).astype(np.float32) for k, s in shapes.items()}
    np.savez(root / name, **arrays)
    meta = json.loads((ADAPTER / "adapter_config.json").read_text())
    meta.update(lora_rank=rank, lora_alpha=alpha)
    (root / "adapter_config.json").write_text(json.dumps(meta))
    return root


def _qa_adapter_shapes(cfg, rank=32) -> dict:
    """Every target's pair at the QA model's geometry."""
    d, n_q, n_kv, hd, inter = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                               cfg.head_dim, cfg.intermediate_size)
    dims = {"self_attn/q_proj": (d, n_q * hd), "self_attn/k_proj": (d, n_kv * hd),
            "self_attn/v_proj": (d, n_kv * hd), "self_attn/o_proj": (n_q * hd, d),
            "mlp/gate_proj": (d, inter), "mlp/up_proj": (d, inter), "mlp/down_proj": (inter, d)}
    out = {}
    for i in range(cfg.num_layers):
        for mod, (n_in, n_out) in dims.items():
            out[f"layers_{i}/{mod}/lora_a"] = (n_in, rank)
            out[f"layers_{i}/{mod}/lora_b"] = (rank, n_out)
    return out


@pytest.fixture(scope="module")
def qa_pair():
    jcfg, jparams = jax_load_qa_lm(QA_CKPT)
    tcfg, state = load_qa_lm(QA_CKPT, device="cpu")
    return jcfg, {"params": jparams}, tcfg, state


@pytest.fixture
def loaded_once(qa_pair, monkeypatch):
    """The port's factory reads the module fixture's base instead of the
    247 MB checkpoint again (the same config and tensors)."""
    from gvl_tpu_torch.training import qa_lm_train

    _, _, tcfg, state = qa_pair
    monkeypatch.setattr(qa_lm_train, "load_qa_lm", lambda path, device="cuda": (tcfg, state))


def test_in_repo_adapter_is_stale_in_both(qa_pair, loaded_once, caplog):
    """ROADMAP C6: the shipped adapter does not fit ``outputs/qa_lm``: both
    merges raise the same ``ValueError``, and both factories warn and
    serve the base weights."""
    jcfg, jvars, tcfg, state = qa_pair
    with pytest.raises(ValueError) as jerr:
        jq.load_adapter_and_merge(jcfg, jvars, str(ADAPTER))
    with pytest.raises(ValueError) as terr:
        tq.load_adapter_and_merge(tcfg, state, ADAPTER)
    assert str(terr.value) == str(jerr.value)
    assert "layers_0/self_attn/q_proj/lora_a has shape (384, 32)" in str(terr.value)
    with caplog.at_level(logging.WARNING):
        core = tcore.create_reasoning_core(checkpoint_path=str(QA_CKPT),
                                           lora_path=str(ADAPTER), device="cpu")
    assert "skipping LoRA adapter" in caplog.text
    served = core.backend.engine.model.state_dict()
    assert all(torch.equal(served[k], v) for k, v in state.items())


def test_c6_other_merge_errors_raise_in_both(qa_pair, loaded_once, tmp_path, monkeypatch):
    """ROADMAP C6, settled: only a ``ValueError`` (a geometry mismatch, or a
    config that is not JSON) falls back to the base; any other failure of
    the merge raises in the port as in JAX: here an adapter config without
    its rank (``KeyError``) and an npz that is not one.  The reference's
    PEFT ladder would serve the base on any exception: the divergence this
    test names."""
    from gvl_tpu.training import qa_lm_train as jqa

    jcfg, jvars, _, state = qa_pair
    monkeypatch.setattr(jqa, "load_qa_lm", lambda path: (jcfg, jvars["params"]))
    no_rank = tmp_path / "no_rank"
    no_rank.mkdir()
    meta = json.loads((ADAPTER / "adapter_config.json").read_text())
    del meta["lora_rank"]
    (no_rank / "adapter_config.json").write_text(json.dumps(meta))
    for factory, kw in ((jcore.create_reasoning_core, {}),
                        (tcore.create_reasoning_core, {"device": "cpu"})):
        with pytest.raises(KeyError, match="lora_rank"):
            factory(checkpoint_path=str(QA_CKPT), lora_path=str(no_rank), **kw)
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "adapter_config.json").write_text((ADAPTER / "adapter_config.json").read_text())
    (broken / "adapter_final.npz").write_bytes(b"PK\x03\x04 truncated zip")
    with pytest.raises(Exception) as err:
        tcore.create_reasoning_core(checkpoint_path=str(QA_CKPT), lora_path=str(broken),
                                    device="cpu")
    assert not isinstance(err.value, ValueError)
    not_json = tmp_path / "not_json"
    not_json.mkdir()
    (not_json / "adapter_config.json").write_text("{")
    core = tcore.create_reasoning_core(checkpoint_path=str(QA_CKPT), lora_path=str(not_json),
                                       device="cpu")
    assert core.backend.engine.model.state_dict()["lm_head.weight"] is not None
    # no adapter_config.json: no adapter, the base served silently
    core = tcore.create_reasoning_core(checkpoint_path=str(QA_CKPT),
                                       lora_path=str(tmp_path), device="cpu")
    assert torch.equal(core.backend.engine.model.state_dict()["lm_head.weight"],
                       state["lm_head.weight"])


def test_newest_step_file_when_no_final(qa_pair, tmp_path):
    """Without ``adapter_final.npz`` the newest ``adapter_step*.npz`` is
    read, as JAX's ``sorted(glob)[-1]``: a seeded step at the QA geometry
    named last merges, the shipped (stale) steps before it are not read."""
    _, _, tcfg, state = qa_pair
    root = tmp_path / "steps"
    root.mkdir()
    for f in ADAPTER.iterdir():
        if f.name != "adapter_final.npz":
            (root / f.name).write_bytes(f.read_bytes())
    with pytest.raises(ValueError, match=r"\(64, 32\)"):
        tq.load_adapter_and_merge(tcfg, state, root)
    shapes = {k: v for k, v in _qa_adapter_shapes(tcfg).items() if k.startswith("layers_0/")}
    _write_adapter(root, shapes, name="adapter_step000900.npz")
    _, merged = tq.load_adapter_and_merge(tcfg, state, root)
    assert not torch.equal(merged["layers.0.mlp.up_proj.weight"],
                           state["layers.0.mlp.up_proj.weight"])
    assert torch.equal(merged["layers.1.mlp.up_proj.weight"], state["layers.1.mlp.up_proj.weight"])


@pytest.fixture(scope="module")
def merged_pair(qa_pair, tmp_path_factory):
    """A seeded rank-32 adapter at the QA geometry (seven targets, every
    ``lora_b`` non-zero), merged by both packages."""
    jcfg, jvars, tcfg, state = qa_pair
    root = _write_adapter(tmp_path_factory.mktemp("adapter"), _qa_adapter_shapes(tcfg))
    jmcfg, jmvars = jq.load_adapter_and_merge(jcfg, jvars, str(root))
    tmcfg, tmstate = tq.load_adapter_and_merge(tcfg, state, root)
    return root, jmcfg, jmvars, tmcfg, tmstate


def test_seeded_adapter_merges_as_jax(qa_pair, merged_pair):
    _, _, tcfg, state = qa_pair
    _, jmcfg, jmvars, tmcfg, tmstate = merged_pair
    assert tmcfg.lora_rank == jmcfg.lora_rank == 0 and tmcfg.lora_alpha == 64.0
    want = params_from_jax(_np(jmvars), tmcfg)
    assert set(tmstate) == set(want) == set(state)
    moved = 0
    for name, w in want.items():
        np.testing.assert_allclose(tmstate[name].numpy(), w.numpy(), atol=MERGED_ATOL,
                                   err_msg=name)
        moved += not torch.equal(tmstate[name], state[name])
    assert moved == 7 * tcfg.num_layers       # every target of every layer


PROMPTS = [
    "## Timeline Context\n[00:03] enemy detected\n[00:09] boss detected\n\n"
    "## Question\nDoes a boss appear? Answer Yes or No.",
    "## Timeline Context\n[00:01] player detected\n[00:05] item detected\n\n"
    "## Question\nAt what timestamp is the item first detected?",
    "## Timeline Context\n[00:02] speech: grab the key and run\n\n## Question\n"
    "What does the voice say?",
    "## Timeline Context\n[00:04] OCR: HP 45\n\n## Question\nWhat is the health value?",
]


def test_merged_model_answers_as_jax(merged_pair, loaded_once):
    """Greedy answers of the merged QA model through both factories'
    ``lora_path`` rung, in f32: equal token for token on 4 prompts."""
    from gvl_tpu.models.byte_tokenizer import BOS_ID, ByteTokenizer
    from gvl_tpu_torch.training.qa_lm_train import render_chatml

    root, jmcfg, jmvars, tmcfg, tmstate = merged_pair
    tcore_ = tcore.create_reasoning_core(checkpoint_path=str(QA_CKPT), lora_path=str(root),
                                         device="cpu")
    served = tcore_.backend.engine.model.state_dict()
    assert all(torch.equal(served[k], v) for k, v in tmstate.items())
    jengine = jq.Qwen3Engine(jmcfg, jmvars, eos_token_id=2, dtype=jnp.float32)
    tengine = tq.Qwen3Engine(tmcfg, tmstate, eos_token_id=2, dtype=torch.float32,
                             device="cpu")
    for prompt in PROMPTS:
        ids = [BOS_ID] + ByteTokenizer().encode(render_chatml("sys", prompt))
        want = jengine.generate(ids, max_new_tokens=12, temperature=0.0)
        got = tengine.generate(ids, max_new_tokens=12, temperature=0.0)
        assert got == want and got, prompt
