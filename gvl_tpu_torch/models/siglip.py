"""SigLIP2-class vision and text towers (counterpart of
:mod:`gvl_tpu.models.siglip`).

Patchify is a reshape and one matrix product (stride equals kernel), the
encoder is a stack of LayerNorm/GELU :class:`~gvl_tpu_torch.nn.layers.
TransformerBlock` layers, and the attention-pooling MAP head gives the
pooled output.  Pixels are channels-last ``[B, H, W, 3]`` as in the JAX
package.  The text tower (:class:`SigLIPTextTower`) carries the trained
retriever.  ``quant_int8`` builds the W8A8 encoder (dynamic activation
scales, or static ones with ``quant_static_act``); :func:`quantize_siglip_int8`
and :func:`calibrate_siglip_int8` make its weights.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.nn.layers import LayerNorm, TransformerBlock, gelu_tanh, load_module
from gvl_tpu_torch.nn.quant import W8A8Dense, bake_act_scales, quantize_kernels_int8


@dataclass(frozen=True)
class SigLIPVisionConfig:
    """Vision-tower hyperparameters (defaults: so400m-patch14-384)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 384
    layer_norm_eps: float = 1e-6
    quant_int8: bool = False        # W8A8 encoder blocks
    quant_static_act: bool = False  # calibrated static activation scales

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.patches_per_side ** 2

    @classmethod
    def so400m(cls) -> "SigLIPVisionConfig":
        return cls()

    @classmethod
    def tiny(cls, image_size: int = 56) -> "SigLIPVisionConfig":
        return cls(hidden_size=64, intermediate_size=128, num_layers=2,
                   num_heads=4, image_size=image_size)


class PatchEmbed(nn.Module):
    """Non-overlapping patchify + linear embed; each P x P patch flattened
    in (row, col, channel) order.  Trailing pixels that do not fill a patch
    are cropped, as a strided convolution drops them."""

    def __init__(self, config: SigLIPVisionConfig, channels: int = 3):
        super().__init__()
        self.patch_size = config.patch_size
        self.proj = nn.Linear(config.patch_size ** 2 * channels, config.hidden_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.proj(patchify(pixels, self.patch_size))


def patchify(pixels: torch.Tensor, p: int) -> torch.Tensor:
    """``[B, H, W, C]`` → ``[B, (H/p)(W/p), p p C]``."""
    b, h, w, c = pixels.shape
    nh, nw = h // p, w // p
    x = pixels[:, : nh * p, : nw * p].reshape(b, nh, p, nw, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, nh * nw, p * p * c)


def resize_pos_embed(pos: torch.Tensor, side: int, nh: int, nw: int) -> torch.Tensor:
    """The learned ``[side², D]`` grid resized bilinearly to ``[nh·nw, D]``
    in f32 (antialiased when shrinking, as ``jax.image.resize``)."""
    d = pos.shape[-1]
    grid = pos.float().reshape(side, side, d).permute(2, 0, 1)[None]
    grid = F.interpolate(grid, size=(nh, nw), mode="bilinear", align_corners=False,
                         antialias=True)
    return grid[0].permute(1, 2, 0).reshape(nh * nw, d)


class MAPHead(nn.Module):
    """Attention-pooling head: a learned probe cross-attends the sequence,
    then a LayerNorm/GELU MLP with a residual."""

    def __init__(self, config: SigLIPVisionConfig):
        super().__init__()
        d = config.hidden_size
        self.num_heads = config.num_heads
        self.eps = config.layer_norm_eps
        self.probe = nn.Parameter(torch.zeros(1, 1, d))
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.o_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.norm = LayerNorm(d, config.layer_norm_eps)
        self.fc1 = nn.Linear(d, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, d)

    use_flash_kernel = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from gvl_tpu_torch.nn.layers import flash_kernel_on

        return map_head(dict(self.named_parameters()), x, self.num_heads, self.eps,
                        kernel=flash_kernel_on(self))


def map_head(p: dict[str, torch.Tensor], x: torch.Tensor, num_heads: int,
             eps: float, kernel: bool = True) -> torch.Tensor:
    """The MAP head as a function of its state dict (``probe``,
    ``q_proj.weight``, ...): ``[B, S, D]`` → ``[B, D]``, computed in the
    promoted type of x and the weights (as Flax promotes); its attention
    through the flash kernel's wrapper, or its plain version without
    ``kernel``."""
    from gvl_tpu_torch.ops.attention import attention_reference, flash_attention

    x = x.to(torch.promote_types(x.dtype, p["q_proj.weight"].dtype))
    batch, _, d = x.shape
    dh = d // num_heads

    def dense(name, t):
        return F.linear(t, p[f"{name}.weight"], p[f"{name}.bias"])

    def heads(t):
        return t.view(batch, -1, num_heads, dh).transpose(1, 2).contiguous()

    probe = p["probe"].expand(batch, 1, d).to(x.dtype)
    attend = flash_attention if kernel else attention_reference
    attn = attend(heads(dense("q_proj", probe)), heads(dense("k_proj", x)),
                  heads(dense("v_proj", x)))
    hidden = dense("o_proj", attn.transpose(1, 2).reshape(batch, 1, d))
    normed = F.layer_norm(hidden.float(), (d,), p["norm.weight"].float(),
                          p["norm.bias"].float(), eps).to(hidden.dtype)
    h = dense("fc2", gelu_tanh(dense("fc1", normed)))
    return (hidden + h)[:, 0]


class SigLIPVisionTower(nn.Module):
    """Embeddings → encoder → post-norm (+ MAP-head pooling)."""

    def __init__(self, config: SigLIPVisionConfig):
        super().__init__()
        self.config = config
        self.patch_embed = PatchEmbed(config)
        self.pos_embed = nn.Parameter(torch.zeros(config.num_patches, config.hidden_size))
        self.layers = nn.ModuleList(
            TransformerBlock(config.hidden_size, config.num_heads,
                             config.intermediate_size, eps=config.layer_norm_eps,
                             quant=config.quant_int8,
                             quant_static=config.quant_static_act)
            for _ in range(config.num_layers))
        self.post_norm = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.head = MAPHead(config)

    def forward(self, pixels: torch.Tensor, *, pool: bool = True) -> dict[str, torch.Tensor]:
        cfg = self.config
        x = self.patch_embed(pixels)
        pos = self.pos_embed
        if x.shape[1] != cfg.num_patches:   # off-size bucket: resize the grid
            pos = resize_pos_embed(pos, cfg.patches_per_side,
                                   pixels.shape[1] // cfg.patch_size,
                                   pixels.shape[2] // cfg.patch_size)
        x = x + pos[None].to(x.dtype)
        for layer in self.layers:
            x = layer(x)
        x = self.post_norm(x)
        out = {"last_hidden_state": x}
        if pool:
            out["pooled"] = self.head(x)
        return out


def load_tower(config: SigLIPVisionConfig, state: dict[str, torch.Tensor],
               device: str | torch.device = "cuda") -> SigLIPVisionTower:
    """A :class:`SigLIPVisionTower` in eval mode on ``device`` holding the
    state dict's tensors (with their types)."""
    device = resolve_device(device)
    with torch.device("meta"):
        tower = SigLIPVisionTower(config)
    return load_module(tower, state, device)


def init_tower_params(config: SigLIPVisionConfig, generator: torch.Generator,
                      dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Random weights as a state dict, drawn from ``generator`` on ``device``
    with the JAX package's initialisers: ``N(0, 1/fan_in)`` matrices (Flax's
    lecun normal, untruncated), zero biases, unit norms, ``N(0, 0.02²)``
    position embeddings, ``N(0, 1)`` probe."""
    device = resolve_device(device)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in SigLIPVisionTower(config).state_dict().items()}
    params = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        w = torch.empty(shape, dtype=torch.float32, device=device)
        if name == "pos_embed":
            w.normal_(0.0, 0.02, generator=generator)
        elif name == "head.probe":
            w.normal_(0.0, 1.0, generator=generator)
        elif leaf == "bias":
            w.zero_()
        elif name.endswith(("ln1.weight", "ln2.weight", "norm.weight")):
            w.fill_(1.0)
        else:   # nn.Linear weight [out, in]
            w.normal_(0.0, 1.0 / math.sqrt(shape[1]), generator=generator)
        params[name] = w.to(dtype)
    return params


def quantize_siglip_int8(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Tower weights → W8A8 weights for a tower built with ``quant_int8``:
    only the encoder layers are quantized; the patch embed and the MAP head
    stay as they are."""
    return quantize_kernels_int8(state, prefix="layers.")


def calibrate_siglip_int8(config: SigLIPVisionConfig, qstate: dict[str, torch.Tensor],
                          sample_pixels) -> dict[str, torch.Tensor]:
    """Run the dynamic W8A8 tower (in f32) over calibration pixels and bake
    each quantized dense's observed activation amax into a static
    ``act_scale``: weights for a tower built with ``quant_static_act``.
    ``sample_pixels`` is one batch or a list of batches, each at its own
    canvas size; the amax is the largest over all of them.  The MAP head
    holds no quantized dense, so it is not run."""
    batches = [sample_pixels] if torch.is_tensor(sample_pixels) else list(sample_pixels)
    dyn_cfg = dataclasses.replace(config, quant_int8=True, quant_static_act=False)
    f32 = {k: v if v.dtype == torch.int8 else v.float() for k, v in qstate.items()}
    tower = load_tower(dyn_cfg, f32, batches[0].device)
    denses = [m for m in tower.modules() if isinstance(m, W8A8Dense)]
    for m in denses:
        m.calibrating, m.calib_amax = True, 0.0
    with torch.inference_mode():
        for pixels in batches:
            tower(pixels.float(), pool=False)
    return bake_act_scales(tower, qstate)


@dataclass(frozen=True)
class SigLIPTextConfig:
    """Text-tower hyperparameters (defaults: so400m's text side)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    vocab_size: int = 32000
    max_position: int = 64
    projection_size: int = 1152
    layer_norm_eps: float = 1e-6

    @classmethod
    def tiny(cls, **kw) -> "SigLIPTextConfig":
        base = dict(hidden_size=32, intermediate_size=64, num_layers=2,
                    num_heads=2, vocab_size=256, max_position=16,
                    projection_size=32)
        base.update(kw)
        return cls(**base)


class SigLIPTextTower(nn.Module):
    """SigLIP text encoder: token + position embeddings, LayerNorm/GELU
    blocks with no mask (pads are attended, as the JAX tower does), a
    final LayerNorm, and the pooled output: the LAST position through the
    projection head."""

    def __init__(self, config: SigLIPTextConfig):
        super().__init__()
        self.config = config
        self.token_embed = nn.Embedding(config.vocab_size, config.hidden_size)
        self.pos_embed = nn.Parameter(torch.zeros(config.max_position, config.hidden_size))
        self.layers = nn.ModuleList(
            TransformerBlock(config.hidden_size, config.num_heads,
                             config.intermediate_size, eps=config.layer_norm_eps)
            for _ in range(config.num_layers))
        self.final_norm = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.head = nn.Linear(config.hidden_size, config.projection_size)

    def forward(self, input_ids: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.token_embed(input_ids.long())
        x = x + self.pos_embed[None, : x.shape[1]].to(x.dtype)
        for layer in self.layers:
            x = layer(x)
        x = self.final_norm(x)
        return {"last_hidden_state": x, "pooled": self.head(x[:, -1])}
