"""Weights for training a perception model from scratch, drawn by the laws
of the JAX package's Flax initialisers, and the layouts of those models'
JAX trees.

The perception trainers start where ``model.init`` starts in the JAX
package: every leaf of the model's Flax tree is drawn by its module's law
(:func:`draw_tree`), and the tree becomes the port's state dict through the
model's converter (``models/convert.py``).  The laws are Flax's:

- ``kernel`` of a Dense or Conv: ``lecun_normal``, a normal truncated at two
  of its standard deviations and scaled so that the variance is 1 / fan-in
  (fan-in: every axis but the last; :class:`Leaf` overrides it where Flax's
  ``DenseGeneral`` flattens other axes);
- ``embedding`` of ``nn.Embed``: N(0, 1 / width), untruncated;
- ``bias`` zero and ``scale`` one;
- any other leaf carries its module's own ``self.param`` initialiser as a
  :class:`Leaf` in the layout (positions N(0, 0.02^2), SigLIP's probe
  N(0, 1), Whisper's convolutions ``he_normal``, SigLIP's constants).

The numbers differ from ``model.init``'s, the laws do not.  A layout
(``*_layout``) is the JAX tree's nesting with shapes (or :class:`Leaf`) at
its leaves; :func:`gvl_tpu_torch.models.convert.tree_from_state` takes the
same layout back to the JAX tree when a trainer saves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Union

import numpy as np
import torch

# the unit normal truncated to [-2, 2] has this standard deviation
_TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class Leaf:
    """A leaf whose law its name does not give: ``law`` is ``"lecun"`` or
    ``"he"`` (truncated, ``arg`` the fan-in, 0 for every axis but the
    last), ``"normal"`` (``arg`` the standard deviation) or ``"constant"``
    (``arg`` the value)."""

    shape: tuple
    law: str
    arg: float = 0.0


Layout = dict


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, Leaf) else tuple(leaf)


def _leaves(layout: Layout, path: tuple = ()) -> list:
    out = []
    for key, value in layout.items():
        if isinstance(value, dict):
            out.extend(_leaves(value, path + (key,)))
        else:
            out.append((path + (key,), value))
    return out


def shapes(layout: Layout) -> Layout:
    """``layout`` with plain shapes at its leaves (what
    :func:`~gvl_tpu_torch.models.convert.tree_from_state` takes)."""
    return {k: shapes(v) if isinstance(v, dict) else _shape(v) for k, v in layout.items()}


def _draw(name: str, leaf, generator: torch.Generator) -> np.ndarray:
    shape = _shape(leaf)
    name = name.rsplit("/", 1)[-1]      # Whisper's "conv1/bias": one escaped name
    w = torch.empty(shape, dtype=torch.float32)
    if isinstance(leaf, Leaf):
        law, arg = leaf.law, leaf.arg
    elif name == "kernel":
        law, arg = "lecun", 0.0
    elif name == "embedding":
        law, arg = "normal", 1.0 / math.sqrt(shape[-1])
    elif name == "bias":
        law, arg = "constant", 0.0
    elif name == "scale":
        law, arg = "constant", 1.0
    else:
        raise ValueError(f"no initialiser for the leaf {name!r}: give it a Leaf")
    if law in ("lecun", "he"):
        fan_in = arg or math.prod(shape[:-1])
        std = math.sqrt((2.0 if law == "he" else 1.0) / fan_in) / _TRUNC_STD
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    elif law == "normal":
        w.normal_(0.0, arg, generator=generator)
    elif law == "constant":
        w.fill_(arg)
    else:
        raise ValueError(f"unknown law {law!r}")
    return w.numpy()


def draw_tree(layout: Layout, generator: torch.Generator) -> dict:
    """A JAX tree of f32 numpy leaves drawn from ``generator`` (a CPU
    generator: the same seed draws the same weights whatever device trains
    them), leaf after leaf in the layout's order."""
    tree: dict = {}
    for path, leaf in _leaves(layout):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _draw(path[-1], leaf, generator)
    return tree


def init_params(convert: Callable[[dict], dict], layout: Layout,
                seed: Union[int, torch.Generator]) -> dict[str, torch.Tensor]:
    """The port's f32 state dict (CPU) of a model drawn from scratch:
    :func:`draw_tree` of ``layout``, through ``convert``."""
    generator = (seed if isinstance(seed, torch.Generator)
                 else torch.Generator().manual_seed(int(seed)))
    return {k: v.float().contiguous() for k, v in convert(draw_tree(layout, generator)).items()}


def as_state(params: dict, convert: Callable[[dict], dict]) -> dict[str, torch.Tensor]:
    """A warm start as the port's state dict: a state dict as it is, a JAX
    tree (nested dicts of arrays) through ``convert``."""
    if all(torch.is_tensor(v) for v in params.values()):
        return params
    return convert(params)


def trainable(model: torch.nn.Module, state: dict[str, torch.Tensor],
              device: torch.device) -> torch.nn.Module:
    """``model`` (built on the meta device) holding f32 copies of ``state``
    on ``device``, every parameter trainable."""
    model.load_state_dict({k: torch.as_tensor(v).to(device, torch.float32, copy=True)
                           for k, v in state.items()}, assign=True)
    return model.to(device).train()


def state_of(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The trained weights as a detached state dict."""
    return {name: t.detach() for name, t in model.state_dict().items()}


# --------------------------------------------------------------------------
# Layouts of the JAX package's perception models
# --------------------------------------------------------------------------

def dense(d_in: int, d_out: int, bias: bool = True) -> Layout:
    out = {"kernel": (d_in, d_out)}
    if bias:
        out["bias"] = (d_out,)
    return out


def norm(d: int) -> Layout:
    return {"scale": (d,), "bias": (d,)}


def attention(d: int, k_bias: bool = True) -> Layout:
    """``gvl_tpu.nn.layers.Attention`` (or Whisper's, whose k_proj has no
    bias) at width ``d``."""
    return {"q_proj": dense(d, d), "k_proj": dense(d, d, k_bias),
            "v_proj": dense(d, d), "o_proj": dense(d, d)}


def block(d: int, mlp: int) -> Layout:
    """A LayerNorm/GELU ``TransformerBlock``."""
    return {"LayerNorm_0": norm(d), "attention": attention(d), "LayerNorm_1": norm(d),
            "mlp": {"fc1": dense(d, mlp), "fc2": dense(mlp, d)}}


def _normal(shape: tuple, std: float) -> Leaf:
    return Leaf(tuple(shape), "normal", std)


def sam_layout(cfg, text_len: int = 16) -> Layout:
    """``gvl_tpu.models.sam.PromptableSegmenter`` (``cfg``: a ``SamConfig``)
    initialised on prompts of ``text_len`` hashed tokens."""
    e, t, d = cfg.encoder_dim, cfg.text_dim, cfg.decoder_dim
    p, up = cfg.patch_size, cfg.patch_size // cfg.mask_downscale
    encoder = {f"layers_{i}": block(e, 4 * e) for i in range(cfg.encoder_layers)}
    encoder["LayerNorm_0"] = norm(e)
    text = {"embed": {"embedding": (cfg.text_vocab, t)},
            "pos": _normal((text_len, t), 0.02), "proj": dense(t, d)}
    text.update({f"layers_{i}": block(t, 4 * t) for i in range(cfg.text_layers)})
    decoder = {"queries": _normal((cfg.num_queries, d), 0.02)}
    for i in range(cfg.decoder_layers):
        decoder.update({f"cross_norm_{i}": norm(d), f"cross_{i}": attention(d),
                        f"self_norm_{i}": norm(d), f"self_{i}": attention(d),
                        f"mlp_norm_{i}": norm(d),
                        f"mlp_{i}": {"fc1": dense(d, 4 * d), "fc2": dense(4 * d, d)}})
    decoder.update({"pixel_head": dense(d, d * up * up), "mask_head": dense(d, d),
                    "score_head": dense(d, 1)})
    return {"params": {
        "image_encoder": {"patch_proj": dense(p * p * 3, e),
                          "pos": _normal((cfg.tokens_per_side ** 2, e), 0.02),
                          "encoder": encoder, "neck": dense(e, d)},
        "text_tower": text, "decoder": decoder}}


def whisper_layout(cfg) -> Layout:
    """``gvl_tpu.models.whisper.WhisperModel``'s params."""
    d, f = cfg.d_model, cfg.ffn_dim
    enc = {"conv1/kernel": Leaf((3, cfg.num_mel_bins, d), "he"), "conv1/bias": (d,),
           "conv2/kernel": Leaf((3, d, d), "he"), "conv2/bias": (d,),
           "final_norm": norm(d)}
    for i in range(cfg.encoder_layers):
        enc[f"layers_{i}"] = {"attn_norm": norm(d), "self_attn": attention(d, k_bias=False),
                              "ff_norm": norm(d), "fc1": dense(d, f), "fc2": dense(f, d)}
    dec = {"embed_tokens": _normal((cfg.vocab_size, d), 0.02),
           "embed_positions": _normal((cfg.max_target_positions, d), 0.02),
           "final_norm": norm(d)}
    for i in range(cfg.decoder_layers):
        dec[f"layers_{i}"] = {"self_norm": norm(d), "self_attn": attention(d, k_bias=False),
                              "cross_norm": norm(d), "cross_attn": attention(d, k_bias=False),
                              "ff_norm": norm(d), "fc1": dense(d, f), "fc2": dense(f, d)}
    return {"encoder": enc, "decoder": dec}


def siglip_vision_layout(cfg) -> Layout:
    """``gvl_tpu.models.siglip.SigLIPVisionTower``'s params (float)."""
    d, m, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    side = cfg.image_size // p
    out = {"patch_embed": {"proj": dense(p * p * 3, d)},
           "pos_embed": _normal((side * side, d), 0.02), "post_norm": norm(d),
           "head": {"probe": _normal((1, 1, d), 1.0), "q_proj": dense(d, d),
                    "k_proj": dense(d, d), "v_proj": dense(d, d), "o_proj": dense(d, d),
                    "norm": norm(d), "fc1": dense(d, m), "fc2": dense(m, d)}}
    out.update({f"layers_{i}": block(d, m) for i in range(cfg.num_layers)})
    return out


def siglip_text_layout(cfg) -> Layout:
    """``gvl_tpu.models.siglip.SigLIPTextTower``'s params."""
    d = cfg.hidden_size
    out = {"token_embed": {"embedding": (cfg.vocab_size, d)},
           "pos_embed": _normal((cfg.max_position, d), 0.02), "final_norm": norm(d),
           "head": dense(d, cfg.projection_size)}
    out.update({f"layers_{i}": block(d, cfg.intermediate_size)
                for i in range(cfg.num_layers)})
    return out


def minisiglip_layout(vision_cfg, text_cfg) -> Layout:
    """``gvl_tpu.training.siglip_train.MiniSigLIP``'s params: both towers,
    ``logit_scale`` log 10 and ``logit_bias`` -10."""
    return {"vision": siglip_vision_layout(vision_cfg), "text": siglip_text_layout(text_cfg),
            "logit_scale": Leaf((), "constant", float(np.log(10.0))),
            "logit_bias": Leaf((), "constant", -10.0)}


def videomae_layout(cfg) -> Layout:
    """``gvl_tpu.models.videomae.VideoMAEEncoder``'s params."""
    d, m = cfg.hidden_size, cfg.intermediate_size
    patch = 3 * cfg.tubelet_size * cfg.patch_size ** 2
    out = {"patch_embed": {"proj": dense(patch, d)}}
    for i in range(cfg.num_layers):
        out[f"layers_{i}"] = {"norm_before": norm(d), "q_proj": dense(d, d),
                              "k_proj": dense(d, d, bias=False), "v_proj": dense(d, d),
                              "o_proj": dense(d, d), "norm_after": norm(d),
                              "fc1": dense(d, m), "fc2": dense(m, d)}
    return out


def clip_classifier_layout(cfg, heads: tuple[int, int, int]) -> Layout:
    """The clip classifier of ``gvl_tpu.training.videomae_train``: the
    encoder and its ``dir_head``, ``kind_head``, ``event_head``
    (``heads``: their widths)."""
    d = cfg.hidden_size
    return {"encoder": videomae_layout(cfg), "dir_head": dense(d, heads[0]),
            "kind_head": dense(d, heads[1]), "event_head": dense(d, heads[2])}


def hico_layout(cfg, pools: tuple[str, ...] = ("frame_to_clip",)) -> Layout:
    """``gvl_tpu.temporal.hico.HierarchicalCompressor``'s params with the
    pools a model's calls create (``compress_frames_to_clip`` alone: the
    FRAME → CLIP pool)."""
    d = cfg.hidden_dim
    out = {"temporal_pe": _normal((cfg.max_positions, d), 0.02)}
    for pool in pools:
        out[pool] = {"query": _normal((1, 1, d), 1.0), "q_proj": dense(d, d),
                     "k_proj": dense(d, d), "v_proj": dense(d, d), "o_proj": dense(d, d),
                     "norm": norm(d)}
    return out


def named_net_layout(model: torch.nn.Module, heads: int = 0) -> Layout:
    """The Flax tree of a port net whose state keys are Flax's own module
    names (the OCR nets, the audio-event net): ``Conv``/``Dense`` weights
    as kernels, LayerNorms as scale and bias, ``pos_embed`` N(0, 0.02^2),
    a ``SelfAttention``'s ``query/key/value/out`` as Flax's
    ``DenseGeneral`` kernels over ``heads`` heads."""
    from gvl_tpu_torch.nn.layers import LayerNorm

    out: dict = {}
    norms = {name for name, m in model.named_modules() if isinstance(m, LayerNorm)}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        if key == "pos_embed":
            out[key] = _normal(shape, 0.02)
            continue
        *mod, leaf = key.split(".")
        name = ".".join(mod)
        node = out
        for part in mod:
            node = node.setdefault(part, {})
        if name in norms:
            node["scale" if leaf == "weight" else "bias"] = shape
        elif mod[-1] in ("query", "key", "value"):
            d = shape[-1] if leaf == "weight" else 0
            node["kernel" if leaf == "weight" else "bias"] = (
                Leaf((shape[1], heads, shape[0] // heads), "lecun", float(d))
                if leaf == "weight" else (heads, shape[0] // heads))
        elif mod[-1] == "out" and leaf == "weight":
            node["kernel"] = (heads, shape[1] // heads, shape[0])
        elif leaf == "weight":
            node["kernel"] = shape[2:][::-1] + shape[1::-1] if len(shape) == 4 else shape[::-1]
        else:
            node["bias"] = shape
    return {"params": out}
