"""Model definitions of the port (counterpart of :mod:`gvl_tpu.models`).

The model families (``siglip``, ``videomae``, ``wav2vec2``, ``whisper``,
``qwen3``, ``qwen3vl``, ``sam`` and the rest) are imported from their own
modules."""

from gvl_tpu_torch.models.projector import MultiModalProjector, ProjectorBank

__all__ = ["MultiModalProjector", "ProjectorBank"]
