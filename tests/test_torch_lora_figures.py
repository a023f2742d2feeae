"""The ``lora`` figure of ``card_figures.py``, the port against the JAX
package answer for answer, on the CPU (``slow``: out of tier-1).

Both packages serve ``outputs/qa_lm`` through ``create_reasoning_core``
with ``lora_path="outputs/lora_adapter"`` and answer ``evaluate_qa_lm``'s
held-out samples (n 60, seed 1234) on the ``causal`` family and on the
default mix, as ``scripts/finetune_lora.py`` measured the adapter.  The
shipped adapter was trained over an older base geometry, so both merges
fail with the same ``ValueError`` and both serve the base weights (ROADMAP
C6); the figure is then the base model's.  The port's count must be within
one answer of JAX's per family (both engines keep a bf16 cache, whose
argmax ties may split), and every differing answer is printed.

    python -m pytest -m slow tests/test_torch_lora_figures.py -s
"""

from pathlib import Path

import pytest

from gvl_tpu.agent.core import create_reasoning_core as jax_core
from gvl_tpu.training.qa_lm_train import evaluate_qa_lm as jax_evaluate
from gvl_tpu_torch.agent.core import create_reasoning_core
from gvl_tpu_torch.training.qa_lm_train import evaluate_qa_lm

REPO = Path(__file__).resolve().parents[1]
SAMPLES, SEED, SLACK = 60, 1234, 1


class Recorder:
    """An engine proxy that keeps each generated token list."""

    def __init__(self, engine):
        self.engine, self.outputs = engine, []

    def generate(self, prompt_ids, **kw):
        out = self.engine.generate(prompt_ids, **kw)
        self.outputs.append(list(out))
        return out


@pytest.fixture(scope="module")
def engines():
    kw = {"checkpoint_path": str(REPO / "outputs" / "qa_lm"),
          "lora_path": str(REPO / "outputs" / "lora_adapter")}
    return (jax_core(**kw).backend.engine,
            create_reasoning_core(device="cpu", **kw).backend.engine)


@pytest.mark.slow
@pytest.mark.parametrize("family", ["causal", "mix"])
def test_lora_figure_within_one_answer_of_jax(engines, family):
    families = ("causal",) if family == "causal" else None
    jax_engine, engine = Recorder(engines[0]), Recorder(engines[1])
    want = jax_evaluate(None, n_samples=SAMPLES, seed=SEED, families=families,
                        engine=jax_engine)
    got = evaluate_qa_lm(n_samples=SAMPLES, seed=SEED, families=families, engine=engine)
    differ = [(i, a, b) for i, (a, b) in enumerate(zip(engine.outputs, jax_engine.outputs))
              if a != b]
    print(f"\nlora {family}: port {got['accuracy']:.4f}, JAX {want['accuracy']:.4f} "
          f"(n {SAMPLES}); answers equal {SAMPLES - len(differ)}/{SAMPLES}")
    for i, a, b in differ:
        print(f"  sample {i}: port {a!r}, JAX {b!r}")
    assert abs(round(got["accuracy"] * SAMPLES) - round(want["accuracy"] * SAMPLES)) <= SLACK
