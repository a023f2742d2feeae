"""Wav2Vec2 audio encoder (counterpart of :mod:`gvl_tpu.models.wav2vec2`).

Raw 16 kHz waveform → frame embeddings at ~49 Hz (1024 wide in
facebook/wav2vec2-large).  A stack of strided 1-D convolutions (per-layer
LayerNorm in the "layer" form, one per-channel GroupNorm after the first
in the "group" form) turns samples into features; a LayerNorm and a
projection take them to the model width; a grouped positional convolution
(torch's weight norm resolved at conversion; one trailing frame cut for an
even kernel) is added; then transformer layers, pre-norm in the "stable"
(lv60-style) form and post-norm otherwise.  The layers' attention goes
through the flash kernel (:func:`gvl_tpu_torch.nn.layers.attend`), as the
JAX model's goes through ``dot_product_attention``.  Tensors are
channels-last ``[B, T, C]`` between the modules, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.nn.layers import LayerNorm, attend, load_module


@dataclass(frozen=True)
class Wav2Vec2Config:
    """Defaults: facebook/wav2vec2-large (stable layer-norm variant)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    conv_dim: tuple[int, ...] = (512,) * 7
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"      # "layer" | "group"
    do_stable_layer_norm: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @classmethod
    def large(cls) -> "Wav2Vec2Config":
        return cls()

    @classmethod
    def tiny(cls, stable: bool = True) -> "Wav2Vec2Config":
        return cls(hidden_size=32, intermediate_size=64, num_layers=1,
                   num_heads=2, conv_dim=(16, 16), conv_kernel=(10, 3),
                   conv_stride=(5, 2), conv_bias=False,
                   feat_extract_norm="layer" if stable else "group",
                   do_stable_layer_norm=stable,
                   num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4)

    def frames_for_samples(self, n: int) -> int:
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return n


class FeatureExtractor(nn.Module):
    """Strided 1-D convolutions, each followed by its norm and exact GELU:
    waveform ``[B, T]`` → features ``[B, T', conv_dim[-1]]``."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        dims = (1, *config.conv_dim)
        self.convs = nn.ModuleList(
            nn.Conv1d(dims[i], dims[i + 1], k, stride=s, bias=config.conv_bias)
            for i, (k, s) in enumerate(zip(config.conv_kernel, config.conv_stride)))
        if config.feat_extract_norm == "layer":
            self.norms = nn.ModuleList(LayerNorm(d, config.layer_norm_eps)
                                       for d in config.conv_dim)
        else:
            self.group_norm = nn.GroupNorm(config.conv_dim[0], config.conv_dim[0],
                                           eps=config.layer_norm_eps)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :]
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.config.feat_extract_norm == "layer":
                x = self.norms[i](x.transpose(1, 2)).transpose(1, 2)
            elif i == 0:
                x = self.group_norm(x)
            x = F.gelu(x)
        return x.transpose(1, 2)


class PositionalConvEmbed(nn.Module):
    """The grouped positional convolution (weight norm already resolved) and
    exact GELU, ``[B, T, D]`` in and out."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        k = config.num_conv_pos_embeddings
        self.conv = nn.Conv1d(config.hidden_size, config.hidden_size, k, padding=k // 2,
                              groups=config.num_conv_pos_embedding_groups)
        self.trim = k % 2 == 0     # torch drops one trailing frame for even kernels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x.transpose(1, 2)).transpose(1, 2)
        if self.trim:
            out = out[:, :-1]
        return F.gelu(out)


class Wav2Vec2Layer(nn.Module):
    """Self-attention and feed-forward, pre-norm (stable) or post-norm."""

    use_flash_kernel = True

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        d = config.hidden_size
        self.num_heads = config.num_heads
        self.stable = config.do_stable_layer_norm
        self.q_proj, self.k_proj, self.v_proj = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        self.o_proj = nn.Linear(d, d)
        self.attn_norm = LayerNorm(d, config.layer_norm_eps)
        self.fc1 = nn.Linear(d, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, d)
        self.ff_norm = LayerNorm(d, config.layer_norm_eps)

    def _attend(self, h: torch.Tensor) -> torch.Tensor:
        batch, seq, d = h.shape

        def split(t):
            return t.view(batch, seq, self.num_heads, -1).transpose(1, 2).contiguous()

        out = attend(self, split(self.q_proj(h)), split(self.k_proj(h)), split(self.v_proj(h)))
        return self.o_proj(out.transpose(1, 2).reshape(batch, seq, d))

    def _feed_forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(h)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stable:
            x = x + self._attend(self.attn_norm(x))
            return x + self._feed_forward(self.ff_norm(x))
        x = self.attn_norm(x + self._attend(x))
        return self.ff_norm(x + self._feed_forward(x))


class Wav2Vec2Encoder(nn.Module):
    """Feature extractor → projection → positional convolution → layers;
    returns ``{"last_hidden_state": [B, T', D], "features": [B, T', C]}``."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.feature_extractor = FeatureExtractor(config)
        self.proj_norm = LayerNorm(config.conv_dim[-1], config.layer_norm_eps)
        self.feature_projection = nn.Linear(config.conv_dim[-1], config.hidden_size)
        self.pos_conv = PositionalConvEmbed(config)
        self.encoder_norm = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.layers = nn.ModuleList(Wav2Vec2Layer(config) for _ in range(config.num_layers))

    def forward(self, wav: torch.Tensor) -> dict[str, torch.Tensor]:
        feats = self.feature_extractor(wav)
        h = self.feature_projection(self.proj_norm(feats))
        h = h + self.pos_conv(h)
        if not self.config.do_stable_layer_norm:
            h = self.encoder_norm(h)
        for layer in self.layers:
            h = layer(h)
        if self.config.do_stable_layer_norm:
            h = self.encoder_norm(h)
        return {"last_hidden_state": h, "features": feats}


# --------------------------------------------------------------------------
# HF conversion
# --------------------------------------------------------------------------

_LAYER_NAMES = {"q_proj": "attention.q_proj", "k_proj": "attention.k_proj",
                "v_proj": "attention.v_proj", "o_proj": "attention.out_proj",
                "attn_norm": "layer_norm", "fc1": "feed_forward.intermediate_dense",
                "fc2": "feed_forward.output_dense", "ff_norm": "final_layer_norm"}


def _pos_conv_weight(sd: dict) -> torch.Tensor:
    """The positional convolution's weight ``[out, in/groups, k]`` with
    torch's weight norm resolved: ``g[k] * v[:, :, k] / ||v[:, :, k]||``."""
    pre = "encoder.pos_conv_embed.conv.parametrizations.weight."
    g, v = sd[pre + "original0"], sd[pre + "original1"]
    norm = v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    return g * v / torch.clamp(norm, min=1e-12)


def convert_hf_wav2vec2(state_dict: dict, config: Wav2Vec2Config) -> dict[str, torch.Tensor]:
    """A HF ``Wav2Vec2Model`` state dict as the port's
    :class:`Wav2Vec2Encoder` state dict (JAX's ``convert_hf_wav2vec2``):
    torch's convolution and linear layouts are kept as they are."""
    sd = {k.removeprefix("wav2vec2."): torch.as_tensor(v) for k, v in state_dict.items()}
    out = {}
    for i in range(len(config.conv_dim)):
        pre = f"feature_extractor.conv_layers.{i}."
        out[f"feature_extractor.convs.{i}.weight"] = sd[pre + "conv.weight"]
        if config.conv_bias:
            out[f"feature_extractor.convs.{i}.bias"] = sd[pre + "conv.bias"]
        norm = (f"feature_extractor.norms.{i}" if config.feat_extract_norm == "layer"
                else "feature_extractor.group_norm" if i == 0 else None)
        if norm:
            out[f"{norm}.weight"] = sd[pre + "layer_norm.weight"]
            out[f"{norm}.bias"] = sd[pre + "layer_norm.bias"]
    for ours, theirs in (("proj_norm", "feature_projection.layer_norm"),
                         ("feature_projection", "feature_projection.projection"),
                         ("encoder_norm", "encoder.layer_norm")):
        out[f"{ours}.weight"], out[f"{ours}.bias"] = sd[theirs + ".weight"], sd[theirs + ".bias"]
    out["pos_conv.conv.weight"] = _pos_conv_weight(sd)
    out["pos_conv.conv.bias"] = sd["encoder.pos_conv_embed.conv.bias"]
    for i in range(config.num_layers):
        for ours, theirs in _LAYER_NAMES.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{ours}.{leaf}"] = sd[f"encoder.layers.{i}.{theirs}.{leaf}"]
    return out


def hf_wav2vec2_config(hf) -> Wav2Vec2Config:
    """The port's config for a HF ``Wav2Vec2Config``."""
    return Wav2Vec2Config(
        hidden_size=hf.hidden_size, intermediate_size=hf.intermediate_size,
        num_layers=hf.num_hidden_layers, num_heads=hf.num_attention_heads,
        conv_dim=tuple(hf.conv_dim), conv_kernel=tuple(hf.conv_kernel),
        conv_stride=tuple(hf.conv_stride), conv_bias=hf.conv_bias,
        feat_extract_norm=hf.feat_extract_norm,
        do_stable_layer_norm=hf.do_stable_layer_norm,
        num_conv_pos_embeddings=hf.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=hf.num_conv_pos_embedding_groups)


def load_hf_wav2vec2(model_name_or_path, config: Optional[Wav2Vec2Config] = None
                     ) -> tuple[Wav2Vec2Config, dict[str, torch.Tensor]]:
    """A HF ``Wav2Vec2Model`` checkpoint (a local directory) as
    ``(config, state_dict)`` on the CPU; ``transformers`` is imported here
    only."""
    from transformers import Wav2Vec2Model

    model = Wav2Vec2Model.from_pretrained(model_name_or_path)
    config = config or hf_wav2vec2_config(model.config)
    return config, convert_hf_wav2vec2(model.state_dict(), config)


def load_wav2vec2(config: Wav2Vec2Config, state: dict[str, torch.Tensor],
                  device: str | torch.device = "cuda") -> Wav2Vec2Encoder:
    """The port's state dict as a :class:`Wav2Vec2Encoder` on ``device``."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = Wav2Vec2Encoder(config)
    return load_module(model, state, device)
