"""Ablation arms for evaluation: which capabilities are on, independent of
the hardware preset (the port's copy of ``benchmarks/model_configs.py``).

Every arm runs end to end through the port's ``FullPipelineRunner``
(:mod:`gvl_tpu_torch.eval.model_inference`) on the ``light`` preset:
``qa_lm`` on the trained QA model, ``gvp_light`` (no segmenter: zero-shot
mini-SigLIP labels and whole-frame embeddings) and ``gvp_full`` (segmenter,
region embeddings, HiCo, projectors at 8 fps) answering with the grounded
fake, as in JAX, where their ``llm_checkpoint`` is empty.  ``use_lora``
reaches no ``process_video`` path in either package (no adapter is loaded).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class EvalModelConfig:
    name: str
    description: str = ""
    # capability toggles
    use_timeline: bool = True
    use_knowledge_base: bool = True
    use_sam: bool = True
    use_siglip: bool = True
    use_ocr: bool = True
    use_asr: bool = True
    use_hico: bool = False
    use_lora: bool = False
    use_projectors: bool = False
    # sampling
    fps: float = 1.0
    max_frames: int = 64
    max_new_tokens: int = 256
    # local LLM checkpoint dir (e.g. the self-trained byte QA LM from
    # scripts/train_qa_lm.py); None → grounded deterministic fake
    llm_checkpoint: str = ""
    extra: dict = field(default_factory=dict)


def baseline_plain() -> EvalModelConfig:
    """Frames straight into the VLM: no external memory, no adapters."""
    return EvalModelConfig(
        name="baseline_plain",
        description="VLM over sampled frames only",
        use_timeline=False, use_knowledge_base=False, use_sam=False,
        use_siglip=False, use_ocr=False, use_asr=False,
        fps=1.0, max_frames=64,
    )


def gvp_light() -> EvalModelConfig:
    """Perception-augmented: SigLIP + ASR/OCR feeding timeline + KB."""
    return EvalModelConfig(
        name="gvp_light",
        description="SigLIP + ASR/OCR + timeline + KB",
        use_sam=False, use_hico=False,
        fps=1.0, max_frames=64,
    )


def gvp_full() -> EvalModelConfig:
    """Everything: segmentation, HiCo, adapters, high-rate sampling."""
    return EvalModelConfig(
        name="gvp_full",
        description="full stack + HiCo + adapters",
        use_hico=True, use_lora=True, use_projectors=True,
        fps=8.0, max_frames=256,
    )


def synthetic_gate() -> EvalModelConfig:
    """The grounded-synthetic regression arm: trained segmenter ON (the
    grounding channel), towers that add no signal on synthetic clips OFF,
    1 fps so the gate runs in CI.  Phase runners use it with
    ``--synthetic`` to assert the retrieval→prompt→generation→parsing
    loop produces CORRECT answers, not just well-formed ones."""
    return EvalModelConfig(
        name="synthetic_gate",
        description="grounded synthetic QA gate (trained segmenter)",
        use_sam=True, use_siglip=False, use_asr=True, use_hico=False,
        fps=1.0, max_frames=32, max_new_tokens=128,
    )


def qa_lm() -> EvalModelConfig:
    """synthetic_gate wiring with the self-trained byte-level QA LM as
    the generator: real learned weights through prefill/decode instead
    of the deterministic context-reading fake.  Measures the trained
    model's end-to-end accuracy on the grounded-synthetic distribution."""
    return EvalModelConfig(
        name="qa_lm",
        description="grounded synthetic QA via the trained byte LM",
        use_sam=True, use_siglip=False, use_asr=True, use_hico=False,
        fps=1.0, max_frames=32, max_new_tokens=128,
        llm_checkpoint="outputs/qa_lm",
    )


_REGISTRY = {
    "baseline_plain": baseline_plain,
    "gvp_light": gvp_light,
    "gvp_full": gvp_full,
    "synthetic_gate": synthetic_gate,
    "qa_lm": qa_lm,
}


def get_model_config(name: str) -> EvalModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown eval config {name!r}; have {list(_REGISTRY)}")
    return _REGISTRY[name]()


def list_model_configs() -> list[str]:
    return list(_REGISTRY)
