"""The JAX package's Qwen3 parameter tree -> the port's ``state_dict``.

The tree is ``gvl_tpu.models.qwen3.Qwen3Model``'s ``params`` as numpy
arrays (what :func:`gvl_tpu_torch.utils.checkpoints.load_flat_npz` reads
from a flat-npz checkpoint): ``layers_{i}/self_attn/q_proj/base/kernel``
and the like, where ``base`` is the ``LoRADense`` level and Flax ``Dense``
kernels are ``[in, out]`` (the port keeps ``nn.Linear``'s ``[out, in]``).
A ``scan_layers`` tree holds every layer's leaves stacked under
``layers/layer/...`` (kernels ``[L, in, out]``).  Either tree converts to
either layout: the port's state dict follows ``config.scan_layers``.
"""

from __future__ import annotations

import numpy as np
import torch

from gvl_tpu_torch.models.qwen3 import Qwen3Config

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _linear(node: dict) -> np.ndarray:
    if "base" in node:          # LoRADense wraps its Dense as "base"
        node = node["base"]
    if "kernel" not in node:
        raise KeyError(f"no float kernel in {sorted(node)} (int8 or LoRA "
                       "parameters are not ported yet)")
    return np.swapaxes(np.asarray(node["kernel"]), -1, -2)


def _layer(layer: dict) -> dict[str, np.ndarray]:
    """One layer's (or, in a scan tree, every layer's stacked) arrays under
    the port's names."""
    out = {"input_norm.weight": np.asarray(layer["input_norm"]["scale"]),
           "post_attn_norm.weight": np.asarray(layer["post_attn_norm"]["scale"])}
    attn = layer["self_attn"]
    for name in _ATTN:
        out[f"self_attn.{name}.weight"] = _linear(attn[name])
    out["self_attn.q_norm.weight"] = np.asarray(attn["q_norm"]["scale"])
    out["self_attn.k_norm.weight"] = np.asarray(attn["k_norm"]["scale"])
    for name in _MLP:
        out[f"mlp.{name}.weight"] = _linear(layer["mlp"][name])
    return out


def params_from_jax(tree: dict, config: Qwen3Config) -> dict[str, torch.Tensor]:
    """``state_dict`` for :class:`~gvl_tpu_torch.models.qwen3.Qwen3Model`."""
    params = tree["params"] if "params" in tree else tree
    out: dict[str, np.ndarray] = {
        "embed_tokens.weight": np.asarray(params["embed_tokens"]["embedding"]),
        "final_norm.weight": np.asarray(params["final_norm"]["scale"]),
    }
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = np.asarray(params["lm_head"]["kernel"]).T
    if "layers" in params:      # scan tree: [L, ...] leaves
        stacked = _layer(params["layers"]["layer"])
        per_layer = [{k: v[i] for k, v in stacked.items()}
                     for i in range(config.num_layers)]
    else:
        per_layer = [_layer(params[f"layers_{i}"])
                     for i in range(config.num_layers)]
    if config.scan_layers:
        for name in per_layer[0]:
            out[f"layers.{name}"] = np.stack([layer[name] for layer in per_layer])
    else:
        for i, layer in enumerate(per_layer):
            out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


# --------------------------------------------------------------------------
# SigLIP vision tower
# --------------------------------------------------------------------------

def _tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 from ml_dtypes included) as a tensor of the
    same type."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))


def _dense(node: dict, prefix: str) -> dict:
    """A Flax ``Dense`` (kernel ``[in, out]``) as ``nn.Linear``'s ``weight``
    ``[out, in]``, or a ``W8A8Dense`` node as its buffers (``kernel_q``
    stays ``[in, out]``)."""
    if "kernel_q" in node:
        return {f"{prefix}.{k}": _tensor(v) for k, v in node.items()}
    out = {f"{prefix}.weight": _tensor(np.asarray(node["kernel"]).T)}
    if "bias" in node:
        out[f"{prefix}.bias"] = _tensor(node["bias"])
    return out


def _norm(node: dict, prefix: str) -> dict:
    return {f"{prefix}.weight": _tensor(node["scale"]), f"{prefix}.bias": _tensor(node["bias"])}


def map_head_from_jax(head: dict, prefix: str = "head") -> dict[str, torch.Tensor]:
    """A Flax ``MAPHead`` tree → the port's ``MAPHead`` state dict."""
    out = {f"{prefix}.probe": _tensor(head["probe"])}
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "fc1", "fc2"):
        out.update(_dense(head[name], f"{prefix}.{name}"))
    out.update(_norm(head["norm"], f"{prefix}.norm"))
    return out


def siglip_params_from_jax(tree: dict, num_layers: int) -> dict[str, torch.Tensor]:
    """A Flax ``SigLIPVisionTower`` tree (numpy leaves; float, W8A8 or
    calibrated W8A8 layers) → the port's ``SigLIPVisionTower`` state dict,
    each leaf keeping its type."""
    params = tree["params"] if "params" in tree else tree
    out = _dense(params["patch_embed"]["proj"], "patch_embed.proj")
    out["pos_embed"] = _tensor(params["pos_embed"])
    for i in range(num_layers):
        layer, pre = params[f"layers_{i}"], f"layers.{i}"
        out.update(_norm(layer["LayerNorm_0"], f"{pre}.ln1"))
        out.update(_norm(layer["LayerNorm_1"], f"{pre}.ln2"))
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out.update(_dense(layer["attention"][name], f"{pre}.attention.{name}"))
        for name in ("fc1", "fc2"):
            out.update(_dense(layer["mlp"][name], f"{pre}.mlp.{name}"))
    out.update(_norm(params["post_norm"], "post_norm"))
    out.update(map_head_from_jax(params["head"]))
    return out


_FUSED_MATRICES = ("w_qkv", "w_o", "w1", "w2")
_FUSED_SCALARS = ("ln1_inv", "attn_inv", "ln2_inv", "gelu_inv")


def fused_from_jax(fused: dict) -> dict:
    """A JAX fused tree (``gvl_tpu.models.siglip_fused.fuse_siglip_int8``,
    numpy leaves) → the port's fused layout: the four int8 matrices
    transposed to ``[N, K]`` (K contiguous), the inverse quantize scales as
    Python floats (their f32 values), the MAP head as its state dict."""
    layers = []
    for lp in fused["layers"]:
        layer = {}
        for k, v in lp.items():
            if k in _FUSED_MATRICES:
                layer[k] = _tensor(np.ascontiguousarray(np.asarray(v).T))
            elif k in _FUSED_SCALARS:
                layer[k] = float(np.float32(v))
            else:
                layer[k] = _tensor(v)
        layers.append(layer)
    bf = fused["bf16"]
    return {"bf16": {
        "patch_kernel": _tensor(bf["patch_kernel"]),
        "patch_bias": _tensor(bf["patch_bias"]),
        "pos_embed": _tensor(bf["pos_embed"]),
        "post_norm_g": _tensor(bf["post_norm_g"]),
        "post_norm_b": _tensor(bf["post_norm_b"]),
        "head": {k[len("head."):]: v for k, v in map_head_from_jax(bf["head"]).items()},
    }, "layers": layers}
