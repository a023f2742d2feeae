"""LoRA training in ``gvl_tpu_torch`` against ``gvl_tpu`` on the CPU:
``train_qa_lm_lora`` over a micro QA checkpoint (hidden 64, 2 layers,
rank 4, three steps of batch 4) and ``LoraTrainer`` on the tiny model with
the word-hash tokenizer (8 chat samples, 2 gradients per update, one epoch),
both from JAX's initial LoRA pairs.

Tolerances: LoRA leaves within 1e-5 (f32); every frozen tensor bit-equal
to the base; ``encode_sample`` and ``dry_run`` equal; the same adapter
files after ``save_total_limit`` retention, their arrays within 1e-5.
Adapters written by either package merge in the other (merged weights
within 1e-6).  ``finetune_lora --llm-checkpoint`` over a tiny HF Qwen3
directory (the branch that waits for a real checkpoint) writes what JAX's
script writes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models import qwen3 as jq
from gvl_tpu.models.sam import hash_tokenize
from gvl_tpu.training import lora_train as jlora
from gvl_tpu.training import qa_lm_train as jtrain
from gvl_tpu_torch.models import qwen3 as tq
from gvl_tpu_torch.models.convert import params_from_jax
from gvl_tpu_torch.training import lora_train as tlora
from gvl_tpu_torch.training import qa_lm_train as ttrain

LORA_TOL = 1e-5
MERGED_TOL = 1e-6
MICRO = dict(hidden_size=64, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=32,
             intermediate_size=128, max_cache_length=1024)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(cfg, seed=0):
    return _np(jq.Qwen3Model(cfg).init(jax.random.PRNGKey(seed),
                                       jnp.zeros((1, 8), jnp.int32))["params"])


@pytest.fixture(scope="module")
def micro_base(tmp_path_factory):
    """A micro QA checkpoint in the JAX layout (random weights)."""
    root = tmp_path_factory.mktemp("qa_base")
    cfg = jtrain.qa_lm_config(**MICRO)
    jtrain.save_qa_lm(_init(cfg, 3), root, cfg)
    return root


def test_train_qa_lm_lora_matches_jax(micro_base, monkeypatch):
    common = dict(steps=3, batch_size=4, max_len=640, lora_rank=4, log_every=0)
    lora_cfg, want = jtrain.train_qa_lm_lora(micro_base, jtrain.LoraQAConfig(**common))
    want = _np(want)
    tcfg = tq.Qwen3Config(**{k: v for k, v in lora_cfg.__dict__.items()})
    init = params_from_jax(_init(lora_cfg, 0), tcfg)       # JAX's draw of the pairs
    monkeypatch.setattr(tq, "init_jax_params", lambda cfg, generator, device: init)
    got_cfg, got = ttrain.train_qa_lm_lora(micro_base, ttrain.LoraQAConfig(**common),
                                           device="cpu")
    assert got_cfg == tcfg
    want_state = params_from_jax(want, tcfg)
    _, base = ttrain.load_qa_lm(micro_base, device="cpu")
    for name, t in got.items():
        if name.endswith(("lora_a", "lora_b")):
            torch.testing.assert_close(t, want_state[name], atol=LORA_TOL, rtol=0, msg=name)
        else:
            assert torch.equal(t, base[name]), name
    assert all(got[n].abs().max() > 0 for n in got if n.endswith("lora_b"))


def test_adapters_merge_in_either_package(micro_base, tmp_path):
    base_cfg, base_params = jtrain.load_qa_lm(micro_base)
    lora_cfg = jq.Qwen3Config(**{**base_cfg.__dict__, "lora_rank": 4})
    lora_params = _init(lora_cfg, 5)
    # non-zero lora_b, so that the merge moves the weights
    lora_params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.01 if getattr(path[-1], "key", "") == "lora_b" else x, lora_params)
    tcfg = tq.Qwen3Config(**lora_cfg.__dict__)
    state = params_from_jax(lora_params, tcfg)
    ttrain.save_qa_lm_adapter(state, tmp_path / "port", tcfg, base_dir=micro_base)
    jtrain.save_qa_lm_adapter(lora_params, tmp_path / "jax", lora_cfg, base_dir=micro_base)
    assert (json.loads((tmp_path / "port" / "adapter_config.json").read_text())
            == json.loads((tmp_path / "jax" / "adapter_config.json").read_text()))
    with np.load(tmp_path / "port" / "adapter_final.npz") as a, \
            np.load(tmp_path / "jax" / "adapter_final.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    _, port_base = ttrain.load_qa_lm(micro_base, device="cpu")
    tbase_cfg = tq.Qwen3Config(**base_cfg.__dict__)
    for adapter in ("port", "jax"):
        jcfg0, jmerged = jq.load_adapter_and_merge(base_cfg, {"params": base_params},
                                                   str(tmp_path / adapter))
        tcfg0, tmerged = tq.load_adapter_and_merge(tbase_cfg, port_base, tmp_path / adapter)
        want = params_from_jax(_np(jmerged["params"]), tcfg0)
        assert tcfg0.lora_rank == 0 and tmerged.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(tmerged[k], want[k], atol=MERGED_TOL, rtol=0)


def _chat_data():
    import random

    rng = random.Random(0)
    words = ["boss", "player", "health", "potion", "cave", "attack", "drops", "at"]
    data = []
    for i in range(8):
        q = " ".join(rng.choice(words) for _ in range(5 + i % 3))
        a = " ".join(rng.choice(words) for _ in range(8 + i % 4))
        data.append({"messages": [{"role": "user", "content": q},
                                  {"role": "assistant", "content": a}]})
    data.append({"messages": [{"role": "user", "content": "no answer"}]})
    return data


def test_lora_trainer_matches_jax(tmp_path):
    cfg = jq.Qwen3Config.tiny(lora_rank=4, max_cache_length=64)
    tcfg = tq.Qwen3Config.tiny(lora_rank=4, max_cache_length=64)
    params = _init(cfg, 0)
    data = [s for s in _chat_data() if len(s["messages"]) == 2]
    path = tmp_path / "data.json"
    path.write_text(json.dumps(_chat_data()))
    assert jlora.load_chat_training_data(path) == tlora.load_chat_training_data(path) == data

    def tokenize(text):
        return hash_tokenize(text, cfg.vocab_size, 64).tolist()

    def train_config(out):
        return dict(learning_rate=1e-2, grad_accum_steps=2, epochs=1, max_seq_len=48,
                    output_dir=str(out), save_steps=2, save_total_limit=2)

    jt = jlora.LoraTrainer(jq.Qwen3Model(cfg), params, tokenize,
                           jlora.LoraTrainingConfig(**train_config(tmp_path / "jax")))
    tt = tlora.LoraTrainer(tcfg, params_from_jax(params, tcfg), tokenize,
                           tlora.LoraTrainingConfig(**train_config(tmp_path / "port")),
                           device="cpu")
    for sample in data:
        a, b = jt.encode_sample(sample), tt.encode_sample(sample)
        assert all(np.array_equal(a[k], b[k]) for k in ("input_ids", "labels"))
    assert jt.dry_run(data) == tt.dry_run(data)
    jres, tres = jt.train(data), tt.train(data)
    assert jres["steps"] == tres["steps"] == 8
    assert abs(jres["final_loss"] - tres["final_loss"]) <= LORA_TOL
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == ["adapter_config.json", "adapter_final.npz", "adapter_step000006.npz",
                     "adapter_step000008.npz"]
    for name in files[1:]:
        with np.load(tmp_path / "jax" / name) as a, np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_allclose(b[k], a[k], atol=LORA_TOL, rtol=0)
    base = params_from_jax(params, tcfg)
    moved = tt.params
    for name, t in moved.items():
        if not name.endswith(("lora_a", "lora_b")):
            assert torch.equal(t, base[name]), name
    # load_adapter puts an earlier adapter back
    tt.load_adapter(tmp_path / "port" / "adapter_step000006.npz")
    with np.load(tmp_path / "port" / "adapter_step000006.npz") as z:
        for name, t in tt.params.items():
            key = tq._jax_key(name, tcfg)
            if key in z.files:
                assert np.array_equal(t.numpy(), z[key])


def test_lora_trainer_refuses_a_mesh_and_rank_zero():
    cfg = tq.Qwen3Config.tiny(lora_rank=4)
    state = tq.init_jax_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    # C17: the mesh is kept and read nowhere, as JAX's trainer keeps it
    # (both packages' trainers with and without one:
    # tests/test_torch_multichip.py)
    marker = object()
    assert tlora.LoraTrainer(cfg, state, list, mesh=marker, device="cpu").mesh is marker
    with pytest.raises(ValueError, match="lora_rank"):
        tlora.LoraTrainer(tq.Qwen3Config.tiny(), state, list, device="cpu")


def test_finetune_lora_over_an_hf_checkpoint_matches_jax(tmp_path, capsys):
    """``finetune_lora --data --llm-checkpoint`` over a tiny HF Qwen3
    directory saved with an offline tokenizer (``test_torch_hf_qwen3``'s):
    ``--dry-run``'s JSON byte for byte, a training run writes the same
    files, the adapter config byte for byte and the same tensor names."""
    from test_torch_hf_qwen3 import save_tiny_qwen3

    from gvl_tpu_torch.scripts import finetune_lora as tscript
    from scripts import finetune_lora as jscript

    hf = save_tiny_qwen3(tmp_path / "hf")
    data = tmp_path / "pairs.json"
    data.write_text(json.dumps(_chat_data()[:4]))
    args = ["--data", str(data), "--llm-checkpoint", str(hf), "--max-seq-len", "32",
            "--lora-rank", "4", "--epochs", "1", "--lr", "1e-3"]
    assert jscript.main(args + ["--dry-run"]) == 0
    want = capsys.readouterr().out
    assert tscript.main(args + ["--dry-run", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and json.loads(want)["num_valid"] == 4
    assert jscript.main(args + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert tscript.main(args + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert ((tmp_path / "port" / "adapter_config.json").read_bytes()
            == (tmp_path / "jax" / "adapter_config.json").read_bytes())
    with np.load(tmp_path / "port" / "adapter_final.npz") as a, \
            np.load(tmp_path / "jax" / "adapter_final.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].shape == b[k].shape for k in a.files)
