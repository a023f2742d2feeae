"""Layers shared by the port's models (counterpart of :mod:`gvl_tpu.nn.layers`)."""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class RMSNorm(nn.Module):
    """Root-mean-square norm over the last axis: f32 accumulation, the
    result cast back to the input's type (``gvl_tpu.nn.layers.RMSNorm``).

    With ``stack=(L,)`` the scale is ``[L, dim]``, one per layer of a model
    whose weights are stacked over layers, and ``index`` picks the layer.
    """

    def __init__(self, dim: int, eps: float = 1e-6, stack: tuple = ()):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(*stack, dim))

    def forward(self, x: torch.Tensor, index: Optional[int] = None) -> torch.Tensor:
        weight = self.weight if index is None else self.weight[index]
        xf = x.float()
        norm = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (norm * weight.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis in f32, the result cast back to the
    input's type (Flax's ``LayerNorm`` as ``gvl_tpu.nn.layers`` uses
    it).  Parameters ``weight`` (scale) and ``bias``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def _dense(in_dim: int, out_dim: int, quant: bool, quant_static: bool,
           use_bias: bool = True) -> nn.Module:
    if quant:
        from gvl_tpu_torch.nn.quant import W8A8Dense

        return W8A8Dense(in_dim, out_dim, use_bias=use_bias, static_act=quant_static)
    return nn.Linear(in_dim, out_dim, bias=use_bias)


_PLAIN_ATTENTION = [False]


@contextlib.contextmanager
def plain_attention():
    """Within this block every attention of the encoder family (:func:`attend`
    and the SigLIP MAP head) takes the plain version, whatever its module's
    ``use_flash_kernel``: a whole pipeline's plain path, built as it is
    served, which the card holds its kernel path to."""
    _PLAIN_ATTENTION[0] = True
    try:
        yield
    finally:
        _PLAIN_ATTENTION[0] = False


def flash_kernel_on(module: nn.Module) -> bool:
    """Whether ``module``'s attention goes through the flash kernel's wrapper."""
    return module.use_flash_kernel and not _PLAIN_ATTENTION[0]


def attend(module: nn.Module, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **kw) -> torch.Tensor:
    """``[B, H, S, dh]`` attention for ``module``: through the flash kernel's
    wrapper (the kernel on CUDA tensors, its plain version on CPU tensors),
    or straight through the plain version when ``module.use_flash_kernel``
    is off or inside :func:`plain_attention`, which is how a model's kernel
    path is held to its plain path on the card (:func:`set_flash_kernel`)."""
    from gvl_tpu_torch.ops.attention import attention_reference, flash_attention

    fn = flash_attention if flash_kernel_on(module) else attention_reference
    return fn(q, k, v, **kw)


def set_flash_kernel(model: nn.Module, on: bool) -> nn.Module:
    """Send every attention of ``model`` through the flash kernel (``on``)
    or through its plain version; returns ``model``."""
    for m in model.modules():
        if hasattr(m, "use_flash_kernel"):
            m.use_flash_kernel = on
    return model


def init_state(model: nn.Module, generator: torch.Generator,
               device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Random f32 weights for ``model`` (built on any device, the meta
    device included) as a state dict on ``device``, drawn from
    ``generator`` in the order of ``model.state_dict()`` with the JAX
    package's initialisers: matrices and convolutions ``N(0, 1/fan_in)``
    (Flax's lecun normal, untruncated), zero biases, unit norms, and
    ``N(0, 0.02²)`` for every other parameter (embeddings, positions,
    queries)."""
    from gvl_tpu_torch import resolve_device

    device = resolve_device(device)
    norms = {f"{name}.weight" for name, m in model.named_modules()
             if isinstance(m, (LayerNorm, nn.LayerNorm, RMSNorm))}
    dense = {f"{name}.weight" for name, m in model.named_modules()
             if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d))}
    state = {}
    for name, t in model.state_dict().items():
        w = torch.empty(t.shape, dtype=torch.float32, device=device)
        if name in norms:
            w.fill_(1.0)
        elif name.rsplit(".", 1)[-1] == "bias":
            w.zero_()
        elif name in dense:
            w.normal_(0.0, 1.0 / math.sqrt(t[0].numel()), generator=generator)
        else:
            w.normal_(0.0, 0.02, generator=generator)
        state[name] = w
    return state


def load_module(model: nn.Module, state: dict[str, torch.Tensor],
                device: str | torch.device = "cuda") -> nn.Module:
    """``model`` (built on the meta device) holding the state dict's tensors,
    in eval mode on ``device``."""
    from gvl_tpu_torch import resolve_device

    device = resolve_device(device)
    model.load_state_dict(state, assign=True)
    return model.to(device).eval()


class Attention(nn.Module):
    """Multi-head self-attention of the encoder family (bias on every
    projection, no mask but an optional key length), input and output
    ``[B, S, D]``; heads go to :func:`gvl_tpu_torch.ops.attention.
    flash_attention` as ``[B, H, S, dh]`` (``gvl_tpu.nn.layers.Attention``
    with ``quant`` / ``quant_static``: W8A8 projections)."""

    use_flash_kernel = True

    def __init__(self, dim: int, num_heads: int, *, quant: bool = False,
                 quant_static: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        inner = num_heads * self.head_dim
        self.q_proj = _dense(dim, inner, quant, quant_static)
        self.k_proj = _dense(dim, inner, quant, quant_static)
        self.v_proj = _dense(dim, inner, quant, quant_static)
        self.o_proj = _dense(inner, dim, quant, quant_static)

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                kv_len: Optional[int] = None) -> torch.Tensor:
        kv_in = x if kv is None else kv
        batch, seq_q, _ = x.shape

        def heads(t):
            return t.view(batch, -1, self.num_heads, self.head_dim).transpose(1, 2).contiguous()

        out = attend(self, heads(self.q_proj(x)), heads(self.k_proj(kv_in)),
                     heads(self.v_proj(kv_in)), kv_len=kv_len)
        out = out.transpose(1, 2).reshape(batch, seq_q, self.num_heads * self.head_dim)
        return self.o_proj(out)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximated GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


class MlpGelu(nn.Module):
    """fc1 → tanh GELU → fc2 (``gvl_tpu.nn.layers.MlpGelu``)."""

    def __init__(self, dim: int, intermediate_dim: int, *, quant: bool = False,
                 quant_static: bool = False):
        super().__init__()
        self.fc1 = _dense(dim, intermediate_dim, quant, quant_static)
        self.fc2 = _dense(intermediate_dim, dim, quant, quant_static)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_tanh(self.fc1(x)))


class TransformerBlock(nn.Module):
    """Pre-norm LayerNorm/GELU encoder layer (``gvl_tpu.nn.layers.
    TransformerBlock`` with ``norm="layernorm"``, ``mlp="gelu"``):
    ``x + attention(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, dim: int, num_heads: int, intermediate_dim: int, *,
                 eps: float = 1e-6, quant: bool = False, quant_static: bool = False):
        super().__init__()
        self.ln1 = LayerNorm(dim, eps)
        self.attention = Attention(dim, num_heads, quant=quant, quant_static=quant_static)
        self.ln2 = LayerNorm(dim, eps)
        self.mlp = MlpGelu(dim, intermediate_dim, quant=quant, quant_static=quant_static)

    def forward(self, x: torch.Tensor, kv_len: Optional[int] = None) -> torch.Tensor:
        x = x + self.attention(self.ln1(x), kv_len=kv_len)
        return x + self.mlp(self.ln2(x))


class TransformerStack(nn.Module):
    """``num_layers`` :class:`TransformerBlock` layers, then a LayerNorm
    (``gvl_tpu.nn.layers.TransformerStack`` with its default LayerNorm/GELU
    blocks and final norm)."""

    def __init__(self, num_layers: int, dim: int, num_heads: int,
                 intermediate_dim: int, *, eps: float = 1e-6):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(dim, num_heads, intermediate_dim, eps=eps)
            for _ in range(num_layers))
        self.final_norm = LayerNorm(dim, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return self.final_norm(x)
