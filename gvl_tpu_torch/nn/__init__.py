"""Layers shared by the port's models (counterpart of :mod:`gvl_tpu.nn`)."""

from gvl_tpu_torch.nn.layers import (
    Attention,
    MlpGelu,
    MlpSwiGLU,
    RMSNorm,
    TransformerBlock,
    TransformerStack,
)

__all__ = [
    "RMSNorm",
    "Attention",
    "MlpGelu",
    "MlpSwiGLU",
    "TransformerBlock",
    "TransformerStack",
]
