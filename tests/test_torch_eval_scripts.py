"""The port's scripts of the evaluation slice against the JAX package's, on
the CPU, in process: ``smoke_test`` (the same 7 checks pass),
``extract_features`` on a 4 s synthetic clip (features JSON and context text
byte for byte, the npz arrays within 1e-5 of each array's largest
magnitude (SigLIP embeddings reach ~20 in f32), the ``.pt`` tensors equal to the
npz arrays), ``demo_projector_inference`` over those embeddings (the same
response), and the single-frame ``BenchmarkModelRunner`` on 4 synthetic
glitchbench samples (the same prompts to the reasoning core, the same
parsed answers).
"""

import numpy as np
import pytest
import torch

from benchmarks.loaders import BenchmarkConfig as JaxConfig
from benchmarks.loaders import GlitchBenchLoader as JaxGlitchBench
from benchmarks.model_inference import BenchmarkModelRunner as JaxSingleFrame
from gvl_tpu_torch.eval.loaders import BenchmarkConfig, GlitchBenchLoader
from gvl_tpu_torch.eval.model_inference import BenchmarkModelRunner
from gvl_tpu_torch.scripts import demo_projector_inference as tdemo
from gvl_tpu_torch.scripts import extract_features as tfeatures
from gvl_tpu_torch.scripts import smoke_test as tsmoke

from scripts import demo_projector_inference as jdemo
from scripts import extract_features as jfeatures
from scripts import smoke_test as jsmoke

NPZ_TOL = 1e-5      # share of each array's largest |value|
CLIP = "synthetic://features_demo?duration=4&fps=2&entities=player,enemy,item&audio=1"
STEM = "synthetic_features_demo"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_smoke_test_checks_pass_as_jax(capsys):
    assert jsmoke.main() == 0
    want = capsys.readouterr().out
    assert tsmoke.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert [c.__doc__ for c in tsmoke.CHECKS] == [c.__doc__ for c in jsmoke.CHECKS]
    assert got == want and got.count("PASS  ") == 7 and "SMOKE TEST: PASS" in got


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """Both scripts' outputs for CLIP: {package: output directory}."""
    root = tmp_path_factory.mktemp("features")
    assert jfeatures.main(["--video", CLIP, "--output-dir", str(root / "jax")]) == 0
    assert tfeatures.main(["--video", CLIP, "--output-dir", str(root / "port"),
                           "--device", "cpu"]) == 0
    return {"jax": root / "jax", "port": root / "port"}


def test_extract_features_as_jax(features):
    jax_dir, port_dir = features["jax"], features["port"]
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(
        p.name for p in jax_dir.iterdir())
    for name in (f"{STEM}_features.json", f"{STEM}_context.txt"):
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name
    with np.load(jax_dir / f"{STEM}_embeddings.npz") as want, \
            np.load(port_dir / f"{STEM}_embeddings.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        arrays = {k: got[k] for k in got.files}
        for key in want.files:
            assert got[key].shape == want[key].shape, key
            scale = float(np.abs(want[key]).max()) if want[key].size else 1.0
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=NPZ_TOL * scale,
                                       err_msg=key)
    assert arrays["siglip"].size and arrays["wav2vec2"].size
    blob = torch.load(port_dir / f"{STEM}_embeddings.pt", weights_only=True)
    assert sorted(blob) == sorted(arrays)
    for key, tensor in blob.items():
        np.testing.assert_array_equal(tensor.numpy(), arrays[key])
    assert (jax_dir / f"{STEM}_embeddings.pt").exists()


def test_extract_features_no_torch_writes_no_pt(tmp_path):
    assert tfeatures.main(["--video", "synthetic://nopt?duration=2&fps=2", "--output-dir",
                           str(tmp_path), "--no-torch", "--skip-hico", "--device", "cpu"]) == 0
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".json", ".npz", ".txt"]


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_demo_projector_inference_as_jax(features, capsys, suffix):
    jdemo.main(["--embeddings", str(features["jax"] / f"{STEM}_embeddings{suffix}")])
    want = capsys.readouterr().out
    tdemo.main(["--embeddings", str(features["port"] / f"{STEM}_embeddings{suffix}"),
                "--device", "cpu"])
    got = capsys.readouterr().out
    assert "[no response]" not in got and "loaded embeddings: siglip=(" in got
    assert got == want


def _single_frame_run(runner, samples):
    """(prompts handed to the reasoning core, parsed answers)."""
    core = runner._get_core()
    prompts, reason = [], core.reason

    def recorded(query, **kw):
        prompts.append(query)
        return reason(query, **kw)

    core.reason = recorded
    answers = [runner.run_inference(s)[0] for s in samples]
    return prompts, answers


def test_single_frame_runner_as_jax():
    want_samples = JaxGlitchBench(JaxConfig(data_dir="/nonexistent", synthetic=True,
                                            max_samples=4)).load()
    samples = GlitchBenchLoader(BenchmarkConfig(data_dir="/nonexistent", synthetic=True,
                                                max_samples=4)).load()
    want = _single_frame_run(JaxSingleFrame(preset="light"), want_samples)
    runner = BenchmarkModelRunner(preset="light", device="cpu")
    got = _single_frame_run(runner, samples)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert all("[Visual Analysis]" in p for p in got[0])
    assert "- Visual analysis unavailable" not in "".join(got[0])
    assert runner.total_samples == 4 and runner.total_inference_time > 0


def test_single_frame_runner_on_a_still_image_as_jax(tmp_path):
    """A GlitchBench still (the directory scan's sample, read with Pillow
    as in JAX): the same prompt and parsed answer."""
    from PIL import Image

    frame = np.zeros((120, 160, 3), np.uint8)
    frame[30:90, 40:120] = (200, 40, 40)
    (tmp_path / "images").mkdir()
    Image.fromarray(frame).save(tmp_path / "images" / "g1.png")
    want_sample = JaxGlitchBench(JaxConfig(data_dir=str(tmp_path))).load()[0]
    sample = GlitchBenchLoader(BenchmarkConfig(data_dir=str(tmp_path))).load()[0]
    want = _single_frame_run(JaxSingleFrame(preset="light"), [want_sample])
    runner = BenchmarkModelRunner(preset="light", device="cpu")
    np.testing.assert_array_equal(runner._load_frame(sample), frame)
    got = _single_frame_run(runner, [sample])
    assert got == want and "[Visual Analysis]" in got[0][0]

