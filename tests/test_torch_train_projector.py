"""``gvl_tpu_torch.training.projector_train`` against
``gvl_tpu.training.projector_train`` on the CPU: the dataset, the fixed
text map, ``evaluate_retrieval``, and ``ProjectorTrainer``'s three
objectives (generative over a frozen micro QA model, cosine, norm) for two
epochs from the same initial heads, on seeded embeddings of three
modalities at small widths.

Tolerances: heads, losses and retrieval within 1e-5 (f32); the frozen
LLM bit-equal after training; ``projector_weights.pt`` written by either
package loads in the other: the same projections, within 1e-5, as the
writer's own file read back (f16 on disk, as both write it).  The
``train_projectors`` script writes what JAX's writes (the same tensor
names, shapes and types).
"""

import json

import jax
import numpy as np
import pytest
import torch

from gvl_tpu.agent.config import ReasoningCoreConfig as JConfig
from gvl_tpu.models.byte_tokenizer import ByteTokenizer
from gvl_tpu.models.projector import ProjectorBank as JBank
from gvl_tpu.models.qwen3 import Qwen3Model
from gvl_tpu.training import projector_train as jproj
from gvl_tpu.training import qa_lm_train as jtrain
from gvl_tpu_torch.agent.config import ReasoningCoreConfig as TConfig
from gvl_tpu_torch.models import qwen3 as tq
from gvl_tpu_torch.models.convert import params_from_jax, projector_params_from_jax
from gvl_tpu_torch.models.projector import ProjectorBank as TBank
from gvl_tpu_torch.scripts import train_projectors as tproj_script
from gvl_tpu_torch.training import projector_train as tproj

from scripts import train_projectors as jproj_script

TOL = 1e-5
DIMS = dict(siglip_dim=24, videomae_dim=16, audiomae_dim=12, internvideo_dim=8,
            llm_hidden_dim=64)
MICRO = dict(hidden_size=64, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=32,
             intermediate_size=128, max_cache_length=1024)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """Two clips' embeddings and feature files, as extract_features writes them."""
    root = tmp_path_factory.mktemp("features")
    rng = np.random.default_rng(0)
    for clip in range(2):
        n = 8
        np.savez(root / f"clip{clip}_embeddings.npz",
                 siglip=rng.standard_normal((n, DIMS["siglip_dim"])).astype(np.float32),
                 siglip_ts=np.arange(n) * 0.5,
                 videomae=rng.standard_normal((n, DIMS["videomae_dim"])).astype(np.float32),
                 wav2vec2=rng.standard_normal((n, DIMS["audiomae_dim"])).astype(np.float32),
                 wav2vec2_ts=np.arange(n) * 0.5 + 0.25)
        (root / f"clip{clip}_features.json").write_text(json.dumps({
            "ocr": [{"timestamp": t * 0.5, "texts": [f"HP {10 * t + clip}"]}
                    for t in range(0, n, 3)],
            "transcription": [{"start": 1.0 + clip, "text": "enemy ahead take cover"}],
            "entities": [{"concept": "boss"}],
        }))
    return root


def test_dataset_and_text_map_match(features):
    jd, td = jproj.MultimodalProjectorDataset(features), tproj.MultimodalProjectorDataset(features)
    assert len(jd) == len(td) == 48 and jd.modality_dims() == td.modality_dims()
    for a, b in zip(jd.samples, td.samples):
        assert (a["modality"], a["text"], a["timestamp"]) == (b["modality"], b["text"],
                                                              b["timestamp"])
        assert np.array_equal(a["embedding"], b["embedding"])
    ja = list(jd.batches("siglip", 5, np.random.default_rng(1)))
    tb = list(td.batches("siglip", 5, np.random.default_rng(1)))
    assert [b["text"] for b in ja] == [b["text"] for b in tb]
    assert np.array_equal(np.asarray(jproj.text_projection_matrix(64, 32)),
                          tproj.text_projection_matrix(64, 32))


def _trainers(objective, features, tmp_path, llm):
    common = dict(epochs=2, batch_size=4, llm_dim=DIMS["llm_hidden_dim"], objective=objective,
                  learning_rate=1e-2, warmup_steps=2, text_dim=32)
    jt = jproj.ProjectorTrainer(
        jproj.ProjectorTrainingConfig(output_path=str(tmp_path / "jax.pt"), **common),
        reasoning_config=JConfig(**DIMS), llm=llm and llm[0])
    tt = tproj.ProjectorTrainer(
        tproj.ProjectorTrainingConfig(output_path=str(tmp_path / "port.pt"), **common),
        reasoning_config=TConfig(**DIMS), llm=llm and llm[1], device="cpu")
    tt.bank.load_params(projector_params_from_jax(jax.tree.map(np.asarray, jt.bank.params)))
    return jt, tt


@pytest.fixture(scope="module")
def micro_llm():
    cfg = jtrain.qa_lm_config(**MICRO)
    params = jax.tree.map(np.asarray, Qwen3Model(cfg).init(
        jax.random.PRNGKey(4), np.zeros((1, 8), np.int32))["params"])
    tcfg = tq.Qwen3Config(**cfg.__dict__)
    tok = ByteTokenizer()
    return ((Qwen3Model(cfg), {"params": params}, tok.encode),
            (tcfg, params_from_jax(params, tcfg), tok.encode))


@pytest.mark.parametrize("objective", ["generative", "cosine", "norm"])
def test_trainer_objectives_match_jax(objective, features, tmp_path, micro_llm):
    llm = micro_llm if objective == "generative" else None
    jt, tt = _trainers("cosine" if llm else objective, features, tmp_path, llm)
    frozen = {k: v.clone() for k, v in micro_llm[1][1].items()}
    dataset_j = jproj.MultimodalProjectorDataset(features)
    dataset_t = tproj.MultimodalProjectorDataset(features)
    jres, tres = jt.train(dataset_j), tt.train(dataset_t)
    assert abs(jres["best_loss"] - tres["best_loss"]) <= TOL
    assert jres["history"].keys() == tres["history"].keys()
    for m in jres["history"]:
        np.testing.assert_allclose(tres["history"][m], jres["history"][m], atol=TOL, rtol=TOL)
    want = projector_params_from_jax(jax.tree.map(np.asarray, jt.bank.params))
    for m in ("siglip", "videomae", "audio"):
        for k, v in want[m].items():
            torch.testing.assert_close(tt.bank.heads[m].state_dict()[k], v, atol=TOL, rtol=0)
    if llm:
        assert all(torch.equal(frozen[k], v) for k, v in micro_llm[1][1].items())
        assert all(torch.equal(frozen[k], v)
                   for k, v in tt.llm_model.state_dict().items())
    jr = jproj.evaluate_retrieval(jt.bank, dataset_j, text_dim=32, llm_dim=64)
    tr = tproj.evaluate_retrieval(tt.bank, dataset_t, text_dim=32, llm_dim=64)
    assert jr == tr
    if objective != "norm":
        return
    # the best epoch's projector_weights.pt of either package loads in the other
    jbank = JBank(JConfig(**DIMS)).init()
    jbank.load_weights(tmp_path / "port.pt")
    tbank = TBank(TConfig(**DIMS), device="cpu").init()
    tbank.load_weights(tmp_path / "jax.pt")
    x = np.random.default_rng(9).standard_normal((3, DIMS["siglip_dim"])).astype(np.float32)
    reread = TBank(TConfig(**DIMS), device="cpu").init()
    reread.load_weights(tmp_path / "port.pt")
    np.testing.assert_allclose(np.asarray(jbank.project_region(x)), reread.project_region(x),
                               atol=TOL, rtol=TOL)
    jreread = JBank(JConfig(**DIMS)).init()
    jreread.load_weights(tmp_path / "jax.pt")
    np.testing.assert_allclose(tbank.project_region(x), np.asarray(jreread.project_region(x)),
                               atol=TOL, rtol=TOL)


def test_train_projectors_writes_what_jax_writes(tmp_path, capsys):
    rng = np.random.default_rng(0)
    feats = tmp_path / "features"
    feats.mkdir()
    n = 8
    np.savez(feats / "clip_embeddings.npz",
             siglip=rng.standard_normal((n, 32)).astype(np.float32),
             videomae=rng.standard_normal((n, 16)).astype(np.float32),
             wav2vec2=rng.standard_normal((n, 24)).astype(np.float32))
    (feats / "clip_features.json").write_text(json.dumps({
        "ocr": [{"timestamp": float(t), "texts": [f"SCORE {t}"]} for t in range(n)]}))
    common = ["--features-dir", str(feats), "--epochs", "1", "--batch-size", "4"]
    assert jproj_script.main(common + ["--output", str(tmp_path / "jax.pt")]) == 0
    assert tproj_script.main(common + ["--output", str(tmp_path / "port.pt"),
                                       "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("done: best_loss=") == 2
    want = torch.load(tmp_path / "jax.pt", weights_only=True)
    got = torch.load(tmp_path / "port.pt", weights_only=True)
    assert got.keys() == want.keys()
    for m in want:
        assert {k: (v.shape, v.dtype) for k, v in got[m].items()} == \
               {k: (v.shape, v.dtype) for k, v in want[m].items()}
