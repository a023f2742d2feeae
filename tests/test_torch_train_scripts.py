"""The port's training scripts against the JAX package's, on the CPU, in
process, on the same arguments: ``generate_training_data`` (the JSON byte
for byte), ``train_qa_lm`` (two short-curriculum steps of the 15M rung
from one warm start: the same files, the config byte for byte, the weights
within 1e-5 but for at most 1e-4 of each tensor, all within the learning
rate), ``finetune_lora --data`` (``--dry-run``'s JSON byte for
byte; a training run writes the same files, the adapter config byte for
byte) and ``harvest_pipeline_prompts`` (one synthetic sample per
loader through the ``synthetic_gate`` arm: the same prompts).
``train_projectors`` is held to JAX's in ``test_torch_train_projector.py``
and ``eval_qa_lm_ckpt`` in ``test_torch_train_qa_lm.py``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from gvl_tpu.utils.checkpoints import load_flat_npz
from gvl_tpu_torch.models.qwen3 import init_jax_params
from gvl_tpu_torch.scripts import finetune_lora as tlora
from gvl_tpu_torch.scripts import generate_training_data as tgen
from gvl_tpu_torch.scripts import harvest_pipeline_prompts as tharvest
from gvl_tpu_torch.scripts import train_qa_lm as ttrain
from gvl_tpu_torch.training import qa_lm_train as tqa

from scripts import finetune_lora as jlora
from scripts import generate_training_data as jgen
from scripts import harvest_pipeline_prompts as jharvest
from scripts import train_qa_lm as jtrain_script

# weights after the script's two steps (the second at learning rate 3e-4):
# within 1e-5 but for at most 1e-4 of a tensor's elements, which stay within
# the learning rate.  Adam divides each gradient by its own running size, so
# a weight whose gradient is within rounding of zero turns the two packages'
# different sums into updates of the learning rate's size.
WEIGHT_TOL, OFF_SHARE, LR = 1e-5, 1e-4, 3e-4
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chat_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("chat")
    assert jgen.main(["--out", str(root / "jax.json"), "--count", "6", "--seed", "3"]) == 0
    assert tgen.main(["--out", str(root / "port.json"), "--count", "6", "--seed", "3"]) == 0
    return root


def test_generate_training_data_byte_for_byte(chat_data):
    data = (chat_data / "port.json").read_bytes()
    assert data == (chat_data / "jax.json").read_bytes()
    assert len(json.loads(data)) == 6


def test_train_qa_lm_script_matches_jax(tmp_path):
    cfg = tqa.qa_lm_config()
    tqa.save_qa_lm(init_jax_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                   tmp_path / "init", cfg)
    init = load_flat_npz(tmp_path / "init" / "params.npz")
    args = ["--curriculum", "short", "--steps", "2", "--batch-size", "1", "--pool-size", "1",
            "--eval-samples", "0", "--init-from", str(tmp_path / "init"), "--seed", "1"]
    assert jtrain_script.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert ttrain.main(args + ["--out", str(tmp_path / "port")] + CPU) == 0
    assert (sorted(p.name for p in (tmp_path / "port").iterdir())
            == sorted(p.name for p in (tmp_path / "jax").iterdir())
            == ["params.npz", "qa_lm_config.json"])
    assert ((tmp_path / "port" / "qa_lm_config.json").read_bytes()
            == (tmp_path / "jax" / "qa_lm_config.json").read_bytes())
    got = load_flat_npz(tmp_path / "port" / "params.npz")
    want = load_flat_npz(tmp_path / "jax" / "params.npz")
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b, c in zip(jax.tree.leaves(got), jax.tree.leaves(want), jax.tree.leaves(init)):
        off = np.abs(a - b) > WEIGHT_TOL
        assert off.mean() <= OFF_SHARE and np.abs(a - b).max() <= LR
        assert not np.array_equal(a, c)


def test_finetune_lora_data_mode_matches_jax(chat_data, tmp_path, capsys):
    data = ["--data", str(chat_data / "port.json")]
    assert jlora.main(data + ["--dry-run"]) == 0
    want = capsys.readouterr().out
    assert tlora.main(data + ["--dry-run"] + CPU) == 0
    assert capsys.readouterr().out == want and json.loads(want)["num_valid"] == 6
    train = data + ["--epochs", "1", "--max-seq-len", "64", "--lr", "1e-3"]
    assert jlora.main(train + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert tlora.main(train + ["--output-dir", str(tmp_path / "port")] + CPU) == 0
    out = capsys.readouterr().out
    assert "done: 6 steps" in out
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == ["adapter_config.json", "adapter_final.npz"]
    assert ((tmp_path / "port" / "adapter_config.json").read_bytes()
            == (tmp_path / "jax" / "adapter_config.json").read_bytes())
    with np.load(tmp_path / "port" / "adapter_final.npz") as a, \
            np.load(tmp_path / "jax" / "adapter_final.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].shape == b[k].shape for k in a.files)


def test_harvest_pipeline_prompts_captures_what_jax_captures(tmp_path, monkeypatch):
    """Each package runs in a working directory of its own: the feature
    cache is written relative to it, and a video restored from the cache
    has a knowledge base without positions (in both packages)."""
    args = ["--per-loader", "1", "--seeds", "42", "--config", "synthetic_gate"]
    for name, main, extra in (("jax", jharvest.main, []), ("port", tharvest.main, CPU)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(args + ["--out", str(tmp_path / f"{name}.jsonl")] + extra) == 0
    got = [json.loads(line) for line in (tmp_path / "port.jsonl").read_text().splitlines()]
    want = [json.loads(line) for line in (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert len(got) == len(want) == 2
    assert got == want
