"""Training: projector alignment and LoRA SFT of the decoder (the
exports of ``gvl_tpu.training``), beside the QA model's trainer
(:mod:`~gvl_tpu_torch.training.qa_lm_train`) and the serving halves of
the perception trainers."""

from gvl_tpu_torch.training.lora_train import (
    LoraTrainer,
    LoraTrainingConfig,
    load_chat_training_data,
)
from gvl_tpu_torch.training.projector_train import (
    MultimodalProjectorDataset,
    ProjectorTrainer,
    ProjectorTrainingConfig,
    evaluate_retrieval,
)

__all__ = [
    "ProjectorTrainingConfig",
    "MultimodalProjectorDataset",
    "ProjectorTrainer",
    "evaluate_retrieval",
    "LoraTrainingConfig",
    "LoraTrainer",
    "load_chat_training_data",
]
