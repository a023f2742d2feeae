"""Attention, cache and rotary operations; CUDA kernels with plain versions
(counterpart of :mod:`gvl_tpu.ops`).  The kernels build at their first
launch, never at import."""

from gvl_tpu_torch.ops.attention import (
    attention_reference,
    dot_product_attention,
    flash_attention,
)
from gvl_tpu_torch.ops.ring_attention import ring_attention
from gvl_tpu_torch.ops.rope import apply_rope, rope_angles

__all__ = [
    "dot_product_attention",
    "flash_attention",
    "attention_reference",
    "ring_attention",
    "apply_rope",
    "rope_angles",
]
