"""W8A8 quantized projection (counterpart of :mod:`gvl_tpu.nn.quant`).

Weights are int8 with a symmetric per-output-channel scale
(:func:`quantize_kernel_int8`); activations are quantized per row from
their own max |x| (dynamic) or by one calibrated per-layer scale (static).
``y = (x_q @ w_q) * s_x * s_w + bias``, the integer product exact.  As in
the JAX package this module is plain tensor code, not a kernel: the fused
serving path (:mod:`gvl_tpu_torch.models.siglip_fused`) is where the int8
kernels run.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gvl_tpu_torch.ops.quant_matmul import int_matmul, true_div


class W8A8Dense(nn.Module):
    """Dense layer on int8 weights and activations.

    Buffers: ``kernel_q`` int8 ``[in, out]`` (the JAX layout), ``scale`` f32
    ``[out]``, ``bias`` f32 ``[out]`` and, when ``static_act``, the 0-d f32
    ``act_scale``.  In dynamic mode, while ``calibrating`` is true, each
    forward raises ``calib_amax`` to the largest |x| it has seen (Flax's
    ``sow`` into the ``calibration`` collection in the JAX package).
    """

    def __init__(self, in_dim: int, out_dim: int, *, use_bias: bool = True,
                 static_act: bool = False):
        super().__init__()
        self.static_act = static_act
        self.register_buffer("kernel_q", torch.zeros(in_dim, out_dim, dtype=torch.int8))
        self.register_buffer("scale", torch.full((out_dim,), 1.0 / 127.0))
        self.register_buffer("bias", torch.zeros(out_dim) if use_bias else None)
        if static_act:
            self.register_buffer("act_scale", torch.tensor(1.0 / 127.0))
        self.calibrating = False
        self.calib_amax = 0.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1]).float()
        if self.static_act:
            sx = self.act_scale
        else:
            amax = xf.abs().amax(-1, keepdim=True)
            if self.calibrating:
                self.calib_amax = max(self.calib_amax, float(amax.max()))
            sx = true_div(torch.clamp(amax, min=1e-8), 127.0)
        xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
        y = int_matmul(xq, self.kernel_q).to(torch.float32) * sx * self.scale[None, :]
        if self.bias is not None:
            y = y + self.bias[None, :]
        return y.reshape(*lead, -1).to(x.dtype)


def quantize_kernel_int8(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[in, out]`` weight → (int8 ``[in, out]``, f32 scale ``[out]``):
    symmetric per output channel, ``scale = max|w| / 127`` over the input
    axis (``quantize_kernels_int8``'s ``quantize_kernel``)."""
    w = kernel.float()
    scale = true_div(torch.clamp(w.abs().amax(-2), min=1e-8), 127.0)
    q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127).to(torch.int8)
    return q, scale


QUANT_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "fc1", "fc2")


def quantize_kernels_int8(state: dict[str, torch.Tensor], prefix: str = "",
                          names=QUANT_NAMES) -> dict[str, torch.Tensor]:
    """A state dict of ``nn.Linear`` layers → the same for ``W8A8Dense``:
    every ``<...>.<name>.weight`` ``[out, in]`` under ``prefix`` whose module
    is named in ``names`` becomes ``kernel_q`` / ``scale`` (and its bias f32);
    everything else passes through (``gvl_tpu.nn.quant.
    quantize_kernels_int8`` on a param tree)."""
    out = dict(state)
    for key in state:
        parts = key.split(".")
        if (key.startswith(prefix) and len(parts) >= 2 and parts[-1] == "weight"
                and parts[-2] in names):
            base = key[: -len("weight")]
            q, scale = quantize_kernel_int8(state[key].T)
            del out[key]
            out[base + "kernel_q"], out[base + "scale"] = q, scale
            if base + "bias" in state:
                out[base + "bias"] = state[base + "bias"].float()
    return out


def bake_act_scales(model: nn.Module, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``state`` plus an ``act_scale`` (observed amax / 127, f32) for every
    dynamic :class:`W8A8Dense` of ``model`` that calibrated, for a model
    rebuilt with ``static_act`` (``gvl_tpu.nn.quant.bake_act_scales``)."""
    out = dict(state)
    for name, module in model.named_modules():
        if isinstance(module, W8A8Dense) and not module.static_act:
            out[f"{name}.act_scale"] = torch.tensor(
                np.float32(max(module.calib_amax, 1e-8) / 127.0))
    return out
