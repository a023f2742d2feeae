"""PyTorch/CUDA port of gvl_tpu for one NVIDIA H100.

The JAX package :mod:`gvl_tpu` stays the reference; this package imports
nothing of it (nor of JAX) and keeps its own copies of the host code it
needs.  Every TPU kernel on a ported path is a CUDA kernel written for
Hopper (``csrc/``), built with one ``nvcc`` command at first use
(:mod:`gvl_tpu_torch.ops._build`) and bound with ``ctypes``.  Beside each
kernel is a plain PyTorch version of the same function: the kernel runs on
CUDA tensors, the plain version on CPU tensors.  The host runtime's C++
(``runtime/csrc/``: video and audio decode, resizes) is built with ``g++``
at first use (:mod:`gvl_tpu_torch.runtime.native`).

Entry points take ``device="cuda"`` by default and raise when no card is
present, unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
