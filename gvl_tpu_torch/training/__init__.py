"""Training: projector alignment and LoRA SFT of the decoder (the
exports of ``gvl_tpu.training``), beside the QA model's trainer
(:mod:`~gvl_tpu_torch.training.qa_lm_train`) and the perception trainers
with their serving halves: the segmenter (``segmenter_train``), the byte
ASR (``asr_train``), the mini-SigLIP and its text corpus (``siglip_train``,
``text_corpus``), the retriever (``retriever_train``) and the VideoMAE clip
classifier (``videomae_train``); the OCR, audio-event and HiCo trainers
live beside their models (``perception/ocr_model.py``,
``audio/event_model.py``, ``temporal/hico.py``).  They draw their weights
from scratch by Flax's laws (``init_laws``) and train with Optax's
optimizers (``optim``)."""

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
