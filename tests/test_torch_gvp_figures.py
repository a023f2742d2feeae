"""The ``gvp_light`` arm's figure, the port against the JAX package on the
same samples, on the trained weights of ``outputs/``, on the CPU (``slow``:
about 25 minutes here, out of tier-1).

Both ``FullPipelineRunner``s answer the synthetic samples of the phase
runners' loaders (n 16 each, seed 42; phase 1: ``glitchbench`` and
``physgame``, phase 3: ``longvideobench`` and ``mlvu``) with the grounded
fake backend.  The port's count must be within one answer of JAX's in each
phase (VERDICT.md read JAX at 0.938 in both); every sample whose answer
differs is printed.  ``python3 card_figures.py --cpu gvp_light`` reads the
port's side alone.

    python -m pytest -m slow tests/test_torch_gvp_figures.py -s
"""

import pytest

from benchmarks.loaders.base import BenchmarkConfig
from benchmarks.loaders.glitchbench import GlitchBenchLoader
from benchmarks.loaders.longvideo import LongVideoBenchLoader, MLVULoader
from benchmarks.loaders.physgame import PhysGameLoader
from benchmarks.model_configs import get_model_config as jax_arm
from benchmarks.model_inference import FullPipelineRunner as JaxRunner
from benchmarks.model_inference import check_correctness as jax_correct
from gvl_tpu_torch import pipeline as tpipe
from gvl_tpu_torch.eval.model_configs import get_model_config as port_arm
from gvl_tpu_torch.eval.model_inference import FullPipelineRunner, check_correctness
from gvl_tpu_torch.eval.samples import SyntheticLoader

from scripts import realtime_inference as jri

PHASES = {"phase 1": (GlitchBenchLoader, PhysGameLoader),
          "phase 3": (LongVideoBenchLoader, MLVULoader)}
SAMPLES, SEED, SLACK = 16, 42, 1


@pytest.mark.slow
@pytest.mark.parametrize("phase", list(PHASES))
def test_gvp_light_count_within_one_answer_of_jax(phase):
    jri._LOOP_COMPONENT_CACHE.clear()
    tpipe._LOOP_COMPONENT_CACHE.clear()
    jax_runner = JaxRunner(jax_arm("gvp_light"), use_cache=False)
    port_runner = FullPipelineRunner(port_arm("gvp_light"), use_cache=False, device="cpu")
    counts, differ = {"jax": 0, "port": 0}, []
    for loader in PHASES[phase]:
        jax_samples = loader(BenchmarkConfig(random_seed=SEED)).synthetic_samples(SAMPLES)
        port_samples = SyntheticLoader(loader.name, SEED).synthetic_samples(SAMPLES)
        for jax_sample, sample in zip(jax_samples, port_samples):
            assert (sample.sample_id, sample.video_path, sample.get_prompt()) == \
                (jax_sample.sample_id, jax_sample.video_path, jax_sample.get_prompt())
            want = jax_runner.run_inference(jax_sample)
            got = port_runner.run_inference(sample)
            assert "error" not in want and "error" not in got, sample.sample_id
            counts["jax"] += jax_correct(want["predicted"], jax_sample)
            counts["port"] += check_correctness(got["predicted"], sample)
            if got["predicted"] != want["predicted"]:
                differ.append((sample.sample_id, want["predicted"], got["predicted"]))
    print(f"gvp_light {phase}: JAX {counts['jax']}/{2 * SAMPLES}, port "
          f"{counts['port']}/{2 * SAMPLES}; answers that differ {differ}")
    assert abs(counts["port"] - counts["jax"]) <= SLACK, (counts, differ)
