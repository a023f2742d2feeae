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
    path is held to its plain path on the card (:func:`set_flash_kernel`).
    Differentiable (``ops.attention.dot_product_attention``)."""
    from gvl_tpu_torch.ops.attention import dot_product_attention

    return dot_product_attention(q, k, v, kernel=flash_kernel_on(module), **kw)


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
    ``generator`` in the order of ``model.state_dict()``: matrices and
    convolutions ``N(0, 1/fan_in)`` (the variance of Flax's lecun normal,
    but untruncated), zero biases, unit norms, and ``N(0, 0.02²)`` for
    every other parameter (embeddings, positions, queries).  These are not
    the JAX package's initialisers (Flax truncates lecun normal at two
    standard deviations and draws embeddings from N(0, 1/width)): they are
    the seeded stand-ins the card's phases serve, and their draws stay as
    they are.  The perception trainers draw by Flax's laws
    (:mod:`gvl_tpu_torch.training.init_laws`)."""
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


def _make_norm(kind: str, dim: int, eps: float) -> nn.Module:
    """The block's norm: ``"rmsnorm"`` (scale only) or ``"layernorm"``
    (Flax's ``LayerNorm``: scale and bias), as ``gvl_tpu.nn.layers._make_norm``."""
    if kind == "rmsnorm":
        return RMSNorm(dim, eps)
    if kind == "layernorm":
        return LayerNorm(dim, eps)
    raise ValueError(f"unknown norm kind: {kind}")


class Attention(nn.Module):
    """Multi-head attention, optionally grouped-query, cross- and rotary
    (``gvl_tpu.nn.layers.Attention``): input ``[B, S, dim]``, output
    ``[B, S, out_dim or dim]``; heads go through :func:`attend` as
    ``[B, H, S, head_dim]``, so the flash kernel takes the causal and
    ``kv_len`` masks and the grouped KV heads.

    ``qk_norm`` puts a per-head RMSNorm (eps 1e-6, whatever the block's
    norm eps) on q and k; ``rope`` rotates q by ``positions`` (default
    ``arange(seq_q)``) and k as well when there is no ``kv``.  Cross-
    attention takes ``kv`` of width ``dim``.  ``quant`` / ``quant_static``:
    W8A8 projections."""

    use_flash_kernel = True

    def __init__(self, dim: int, num_heads: int, *, num_kv_heads: Optional[int] = None,
                 head_dim: Optional[int] = None, out_dim: Optional[int] = None,
                 use_bias: bool = True, causal: bool = False, qk_norm: bool = False,
                 rope: bool = False, rope_base: float = 10000.0, quant: bool = False,
                 quant_static: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = head_dim or dim // num_heads
        self.causal, self.rope, self.rope_base = causal, rope, rope_base
        q_width, kv_width = num_heads * self.head_dim, self.num_kv_heads * self.head_dim
        self.q_proj = _dense(dim, q_width, quant, quant_static, use_bias)
        self.k_proj = _dense(dim, kv_width, quant, quant_static, use_bias)
        self.v_proj = _dense(dim, kv_width, quant, quant_static, use_bias)
        self.o_proj = _dense(q_width, out_dim or dim, quant, quant_static, use_bias)
        self.q_norm = RMSNorm(self.head_dim) if qk_norm else None
        self.k_norm = RMSNorm(self.head_dim) if qk_norm else None

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None, *,
                positions: Optional[torch.Tensor] = None,
                kv_len: Optional[int] = None) -> torch.Tensor:
        kv_in = x if kv is None else kv
        batch, seq_q, _ = x.shape

        def heads(t, n):   # [B, S, n, dh]
            return t.view(batch, -1, n, self.head_dim)

        q = heads(self.q_proj(x), self.num_heads)
        k = heads(self.k_proj(kv_in), self.num_kv_heads)
        v = heads(self.v_proj(kv_in), self.num_kv_heads)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        if self.rope:
            from gvl_tpu_torch.ops.rope import apply_rope, rope_angles

            pos = positions if positions is not None else torch.arange(seq_q, device=x.device)
            cos, sin = rope_angles(pos, self.head_dim, self.rope_base)
            q = apply_rope(q, cos, sin)
            if kv is None:
                k = apply_rope(k, cos, sin)
        out = attend(self, q.contiguous(), k.contiguous(), v.contiguous(),
                     causal=self.causal, kv_len=kv_len)
        out = out.transpose(1, 2).reshape(batch, seq_q, self.num_heads * self.head_dim)
        return self.o_proj(out)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximated GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


class MlpGelu(nn.Module):
    """fc1 → ``act`` (tanh GELU) → fc2 (``gvl_tpu.nn.layers.MlpGelu``)."""

    def __init__(self, dim: int, intermediate_dim: int, *, act=gelu_tanh,
                 use_bias: bool = True, quant: bool = False, quant_static: bool = False):
        super().__init__()
        self.act = act
        self.fc1 = _dense(dim, intermediate_dim, quant, quant_static, use_bias)
        self.fc2 = _dense(intermediate_dim, dim, quant, quant_static, use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class MlpSwiGLU(nn.Module):
    """gate/up/down SwiGLU MLP of the decoder family
    (``gvl_tpu.nn.layers.MlpSwiGLU``): ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, dim: int, intermediate_dim: int, *, use_bias: bool = False):
        super().__init__()
        self.gate_proj = nn.Linear(dim, intermediate_dim, bias=use_bias)
        self.up_proj = nn.Linear(dim, intermediate_dim, bias=use_bias)
        self.down_proj = nn.Linear(intermediate_dim, dim, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class TransformerBlock(nn.Module):
    """Pre-norm transformer layer of either family (``gvl_tpu.nn.layers.
    TransformerBlock``): ``x + attention(ln1(x))``, then ``x + mlp(ln2(x))``.
    ``norm`` is ``"layernorm"`` or ``"rmsnorm"``, ``mlp`` ``"gelu"`` or
    ``"swiglu"``; the SwiGLU MLP has no biases whatever ``use_bias`` says,
    as in the JAX block."""

    def __init__(self, dim: int, num_heads: int, intermediate_dim: int, *,
                 num_kv_heads: Optional[int] = None, head_dim: Optional[int] = None,
                 norm: str = "layernorm", mlp: str = "gelu", causal: bool = False,
                 rope: bool = False, rope_base: float = 10000.0, qk_norm: bool = False,
                 use_bias: bool = True, norm_eps: float = 1e-6, quant: bool = False,
                 quant_static: bool = False):
        super().__init__()
        self.ln1 = _make_norm(norm, dim, norm_eps)
        self.attention = Attention(
            dim, num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
            use_bias=use_bias, causal=causal, qk_norm=qk_norm, rope=rope,
            rope_base=rope_base, quant=quant, quant_static=quant_static)
        self.ln2 = _make_norm(norm, dim, norm_eps)
        if mlp == "swiglu":
            self.mlp = MlpSwiGLU(dim, intermediate_dim)
        else:
            self.mlp = MlpGelu(dim, intermediate_dim, use_bias=use_bias, quant=quant,
                               quant_static=quant_static)

    def forward(self, x: torch.Tensor, *, positions: Optional[torch.Tensor] = None,
                kv_len: Optional[int] = None) -> torch.Tensor:
        x = x + self.attention(self.ln1(x), positions=positions, kv_len=kv_len)
        return x + self.mlp(self.ln2(x))


class TransformerStack(nn.Module):
    """``num_layers`` :class:`TransformerBlock` layers, then the block's norm
    when ``final_norm`` (``gvl_tpu.nn.layers.TransformerStack``; its blocks
    take no ``quant``, as the JAX stack passes none)."""

    def __init__(self, num_layers: int, dim: int, num_heads: int, intermediate_dim: int, *,
                 num_kv_heads: Optional[int] = None, head_dim: Optional[int] = None,
                 norm: str = "layernorm", mlp: str = "gelu", causal: bool = False,
                 rope: bool = False, rope_base: float = 10000.0, qk_norm: bool = False,
                 use_bias: bool = True, norm_eps: float = 1e-6, final_norm: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(dim, num_heads, intermediate_dim, num_kv_heads=num_kv_heads,
                             head_dim=head_dim, norm=norm, mlp=mlp, causal=causal,
                             rope=rope, rope_base=rope_base, qk_norm=qk_norm,
                             use_bias=use_bias, norm_eps=norm_eps)
            for _ in range(num_layers))
        self.final_norm = _make_norm(norm, dim, norm_eps) if final_norm else None

    def forward(self, x: torch.Tensor, *, positions: Optional[torch.Tensor] = None,
                kv_len: Optional[int] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, positions=positions, kv_len=kv_len)
        return x if self.final_norm is None else self.final_norm(x)
