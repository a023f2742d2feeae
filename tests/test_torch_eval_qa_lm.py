"""The port's ``run_phase1`` on the ``qa_lm`` arm (the trained QA model
answering from the trained encoders' timeline) against the JAX package's,
on the CPU, in process: the same ``predicted`` and ``correct`` and the
same aggregate accuracy.  An answer prefills into the 4096 bucket (about
30 s on one CPU thread), so one sample is answered by each package,
in a file of its own.
"""

import pytest
import torch

from benchmarks import run_phase1 as j1
from gvl_tpu_torch.eval import run_phase1 as t1
from test_torch_eval_phases import assert_same_results, run_both


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_run_phase1_qa_lm_as_jax(tmp_path, monkeypatch):
    argv = ["--synthetic", "--max-samples", "1", "--benchmark", "glitchbench",
            "--configs", "qa_lm"]
    want, got = run_both(tmp_path, monkeypatch, j1.main, t1.main, argv, "phase1")
    assert_same_results(want, got, 1)
    assert all(s["predicted"] for s in got[0])
