"""The JAX package's Qwen3 parameter tree -> the port's ``state_dict``.

The tree is ``gvl_tpu.models.qwen3.Qwen3Model``'s ``params`` as numpy
arrays (what :func:`gvl_tpu_torch.utils.checkpoints.load_flat_npz` reads
from a flat-npz checkpoint): ``layers_{i}/self_attn/q_proj/base/kernel``
and the like, where ``base`` is the ``LoRADense`` level and Flax ``Dense``
kernels are ``[in, out]`` (the port keeps ``nn.Linear``'s ``[out, in]``).
A ``scan_layers`` tree holds every layer's leaves stacked under
``layers/layer/...`` (kernels ``[L, in, out]``).  An int8 tree's
``kernel_q`` (``Int8Dense``) becomes ``weight_q`` ``[out, in]`` beside its
``scale``; LoRA's ``lora_a`` ``[in, r]`` and ``lora_b`` ``[r, out]`` keep
their orientation.  Either tree converts to
either layout: the port's state dict follows ``config.scan_layers``.
"""

from __future__ import annotations

import numpy as np
import torch

from gvl_tpu_torch.models.qwen3 import Qwen3Config

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _linear(node: dict, prefix: str) -> dict[str, np.ndarray]:
    """A ``LoRADense`` (its Dense or ``Int8Dense`` as "base", its LoRA
    pair beside it), or a bare Dense / ``Int8Dense``, under the port's
    ``Linear`` names."""
    out = {f"{prefix}.{k}": np.asarray(node[k]) for k in ("lora_a", "lora_b") if k in node}
    base = node.get("base", node)
    if "kernel_q" in base:
        out[f"{prefix}.weight_q"] = np.swapaxes(np.asarray(base["kernel_q"]), -1, -2)
        out[f"{prefix}.scale"] = np.asarray(base["scale"])
    else:
        out[f"{prefix}.weight"] = np.swapaxes(np.asarray(base["kernel"]), -1, -2)
    return out


def _layer(layer: dict) -> dict[str, np.ndarray]:
    """One layer's (or, in a scan tree, every layer's stacked) arrays under
    the port's names."""
    out = {"input_norm.weight": np.asarray(layer["input_norm"]["scale"]),
           "post_attn_norm.weight": np.asarray(layer["post_attn_norm"]["scale"])}
    attn = layer["self_attn"]
    for name in _ATTN:
        out.update(_linear(attn[name], f"self_attn.{name}"))
    out["self_attn.q_norm.weight"] = np.asarray(attn["q_norm"]["scale"])
    out["self_attn.k_norm.weight"] = np.asarray(attn["k_norm"]["scale"])
    for name in _MLP:
        out.update(_linear(layer["mlp"][name], f"mlp.{name}"))
    return out


def params_from_jax(tree: dict, config: Qwen3Config) -> dict[str, torch.Tensor]:
    """``state_dict`` for :class:`~gvl_tpu_torch.models.qwen3.Qwen3Model`."""
    params = tree["params"] if "params" in tree else tree
    out: dict[str, np.ndarray] = {
        "embed_tokens.weight": np.asarray(params["embed_tokens"]["embedding"]),
        "final_norm.weight": np.asarray(params["final_norm"]["scale"]),
    }
    if not config.tie_word_embeddings:
        out.update(_linear(params["lm_head"], "lm_head"))
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


def _attention(node: dict, prefix: str) -> dict:
    """Four Flax ``Dense`` projections q/k/v/o (``gvl_tpu.nn.layers.
    Attention``, or Whisper's, whose k_proj has no bias)."""
    out = {}
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        out.update(_dense(node[name], f"{prefix}.{name}"))
    return out


def _mlp(node: dict, prefix: str) -> dict:
    out = _dense(node["fc1"], f"{prefix}.fc1")
    out.update(_dense(node["fc2"], f"{prefix}.fc2"))
    return out


def block_from_jax(layer: dict, prefix: str) -> dict:
    """A Flax LayerNorm/GELU ``TransformerBlock`` → the port's block."""
    out = _norm(layer["LayerNorm_0"], f"{prefix}.ln1")
    out.update(_norm(layer["LayerNorm_1"], f"{prefix}.ln2"))
    out.update(_attention(layer["attention"], f"{prefix}.attention"))
    out.update(_mlp(layer["mlp"], f"{prefix}.mlp"))
    return out


def stack_from_jax(node: dict, prefix: str, num_layers: int) -> dict:
    """A Flax ``TransformerStack`` (blocks ``layers_{i}``, its final norm
    ``LayerNorm_0``) → the port's ``TransformerStack``."""
    out = {}
    for i in range(num_layers):
        out.update(block_from_jax(node[f"layers_{i}"], f"{prefix}.layers.{i}"))
    out.update(_norm(node["LayerNorm_0"], f"{prefix}.final_norm"))
    return out


def siglip_params_from_jax(tree: dict, num_layers: int) -> dict[str, torch.Tensor]:
    """A Flax ``SigLIPVisionTower`` tree (numpy leaves; float, W8A8 or
    calibrated W8A8 layers) → the port's ``SigLIPVisionTower`` state dict,
    each leaf keeping its type."""
    params = tree["params"] if "params" in tree else tree
    out = _dense(params["patch_embed"]["proj"], "patch_embed.proj")
    out["pos_embed"] = _tensor(params["pos_embed"])
    for i in range(num_layers):
        out.update(block_from_jax(params[f"layers_{i}"], f"layers.{i}"))
    out.update(_norm(params["post_norm"], "post_norm"))
    out.update(map_head_from_jax(params["head"]))
    return out


def siglip_text_params_from_jax(tree: dict, num_layers: int) -> dict[str, torch.Tensor]:
    """A Flax ``SigLIPTextTower`` tree → the port's ``SigLIPTextTower``."""
    params = tree["params"] if "params" in tree else tree
    out = {"token_embed.weight": _tensor(params["token_embed"]["embedding"]),
           "pos_embed": _tensor(params["pos_embed"])}
    for i in range(num_layers):
        out.update(block_from_jax(params[f"layers_{i}"], f"layers.{i}"))
    out.update(_norm(params["final_norm"], "final_norm"))
    out.update(_dense(params["head"], "head"))
    return out


def minisiglip_params_from_jax(tree: dict, vision_config, text_config) -> dict[str, torch.Tensor]:
    """A Flax ``MiniSigLIP`` tree (``vision``, ``text``, ``logit_scale``,
    ``logit_bias``) → the port's ``MiniSigLIP`` state dict."""
    params = tree["params"] if "params" in tree else tree
    out = {f"vision.{k}": v for k, v in
           siglip_params_from_jax(params["vision"], vision_config.num_layers).items()}
    out.update({f"text.{k}": v for k, v in
                siglip_text_params_from_jax(params["text"], text_config.num_layers).items()})
    out["logit_scale"] = _tensor(params["logit_scale"])
    out["logit_bias"] = _tensor(params["logit_bias"])
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


# --------------------------------------------------------------------------
# Perception encoders: segmenter, OCR nets, audio-event net, Whisper
# --------------------------------------------------------------------------

def sam_params_from_jax(tree: dict, config) -> dict[str, torch.Tensor]:
    """A Flax ``PromptableSegmenter`` tree → the port's
    ``PromptableSegmenter`` state dict (``config``: its ``SamConfig``)."""
    params = tree["params"] if "params" in tree else tree
    enc, text, dec = params["image_encoder"], params["text_tower"], params["decoder"]
    out = _dense(enc["patch_proj"], "image_encoder.patch_proj")
    out["image_encoder.pos"] = _tensor(enc["pos"])
    out.update(stack_from_jax(enc["encoder"], "image_encoder.encoder", config.encoder_layers))
    out.update(_dense(enc["neck"], "image_encoder.neck"))
    out["text_tower.embed.weight"] = _tensor(text["embed"]["embedding"])
    out["text_tower.pos"] = _tensor(text["pos"])
    for i in range(config.text_layers):
        out.update(block_from_jax(text[f"layers_{i}"], f"text_tower.layers.{i}"))
    out.update(_dense(text["proj"], "text_tower.proj"))
    out["decoder.queries"] = _tensor(dec["queries"])
    for i in range(config.decoder_layers):
        for kind in ("cross", "self"):
            out.update(_attention(dec[f"{kind}_{i}"], f"decoder.{kind}_{i}"))
        for kind in ("cross_norm", "self_norm", "mlp_norm"):
            out.update(_norm(dec[f"{kind}_{i}"], f"decoder.{kind}_{i}"))
        out.update(_mlp(dec[f"mlp_{i}"], f"decoder.mlp_{i}"))
    for name in ("pixel_head", "mask_head", "score_head"):
        out.update(_dense(dec[name], f"decoder.{name}"))
    return out


def _conv(node: dict, prefix: str) -> dict:
    """A Flax ``Conv`` (kernel HWIO, or WIO in one dimension) → torch's
    ``weight`` (OIHW / OIW) and ``bias``."""
    kernel = np.asarray(node["kernel"])
    axes = (3, 2, 0, 1) if kernel.ndim == 4 else (2, 1, 0)
    return {f"{prefix}.weight": _tensor(np.ascontiguousarray(kernel.transpose(axes))),
            f"{prefix}.bias": _tensor(node["bias"])}


def _self_attention(node: dict, prefix: str) -> dict:
    """A Flax ``SelfAttention`` (``query/key/value`` kernels ``[d, heads,
    dh]``, ``out`` ``[heads, dh, d]``) → four ``nn.Linear`` states."""
    out = {}
    for name in ("query", "key", "value"):
        k = np.asarray(node[name]["kernel"])
        out[f"{prefix}.{name}.weight"] = _tensor(k.reshape(k.shape[0], -1).T)
        out[f"{prefix}.{name}.bias"] = _tensor(np.asarray(node[name]["bias"]).reshape(-1))
    k = np.asarray(node["out"]["kernel"])
    out[f"{prefix}.out.weight"] = _tensor(k.reshape(-1, k.shape[-1]).T)
    out[f"{prefix}.out.bias"] = _tensor(node["out"]["bias"])
    return out


def ocr_net_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """A Flax OCR net (``TextDetectorNet``, ``TextRecognizerNet`` or
    ``TextRecognizerNetV2``) → the port's net of the same name; the state
    keys are the Flax names (``Conv_0``, ``Dense_0``, ``attn_0``, ...)."""
    params = tree["params"] if "params" in tree else tree
    out = {}
    for name, node in params.items():
        if name.startswith("Conv_"):
            out.update(_conv(node, name))
        elif name.startswith("attn_"):
            out.update(_self_attention(node, name))
        elif name.startswith(("ln", "LayerNorm")):
            out.update(_norm(node, name))
        elif name == "pos_embed":
            out[name] = _tensor(node)
        else:
            out.update(_dense(node, name))
    return out


def event_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """A Flax ``AudioEventNet`` tree → the port's ``AudioEventNet``."""
    params = tree["params"] if "params" in tree else tree
    out = {}
    for name, node in params.items():
        out.update(_conv(node, name) if name.startswith("conv") else _dense(node, name))
    return out


def whisper_params_from_jax(tree: dict, config) -> dict[str, torch.Tensor]:
    """A Flax ``WhisperModel`` tree (encoder convs stored as
    ``conv1/kernel``: one escaped name) → the port's ``WhisperModel``."""
    params = tree["params"] if "params" in tree else tree
    enc, dec = params["encoder"], params["decoder"]
    out = {}
    for conv in ("conv1", "conv2"):
        node = {"kernel": enc[f"{conv}/kernel"], "bias": enc[f"{conv}/bias"]}
        out.update(_conv(node, f"encoder.{conv}"))
    for i in range(config.encoder_layers):
        layer, pre = enc[f"layers_{i}"], f"encoder.layers.{i}"
        out.update(_norm(layer["attn_norm"], f"{pre}.attn_norm"))
        out.update(_attention(layer["self_attn"], f"{pre}.self_attn"))
        out.update(_norm(layer["ff_norm"], f"{pre}.ff_norm"))
        out.update(_mlp(layer, pre))
    out.update(_norm(enc["final_norm"], "encoder.final_norm"))
    out["decoder.embed_tokens"] = _tensor(dec["embed_tokens"])
    out["decoder.embed_positions"] = _tensor(dec["embed_positions"])
    for i in range(config.decoder_layers):
        layer, pre = dec[f"layers_{i}"], f"decoder.layers.{i}"
        for norm in ("self_norm", "cross_norm", "ff_norm"):
            out.update(_norm(layer[norm], f"{pre}.{norm}"))
        for attn in ("self_attn", "cross_attn"):
            out.update(_attention(layer[attn], f"{pre}.{attn}"))
        out.update(_mlp(layer, pre))
    out.update(_norm(dec["final_norm"], "decoder.final_norm"))
    return out


def projector_params_from_jax(tree: dict) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX ``ProjectorBank``'s params (``{modality: {fc_in, fc_out}}``,
    or its flat-npz tree) → one ``MultiModalProjector`` state dict per
    modality."""
    params = tree["params"] if "params" in tree else tree
    return {name: {**_dense(node["fc_in"], "fc_in"), **_dense(node["fc_out"], "fc_out")}
            for name, node in params.items()}


# --------------------------------------------------------------------------
# Temporal: VideoMAE, the trained clip classifier, HiCo
# --------------------------------------------------------------------------

def videomae_params_from_jax(tree: dict, config) -> dict[str, torch.Tensor]:
    """A Flax ``VideoMAEEncoder`` tree → the port's ``VideoMAEEncoder``."""
    params = tree["params"] if "params" in tree else tree
    out = _dense(params["patch_embed"]["proj"], "patch_embed.proj")
    for i in range(config.num_layers):
        layer, pre = params[f"layers_{i}"], f"layers.{i}"
        for name in ("norm_before", "norm_after"):
            out.update(_norm(layer[name], f"{pre}.{name}"))
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "fc1", "fc2"):
            out.update(_dense(layer[name], f"{pre}.{name}"))
    return out


def clip_classifier_params_from_jax(tree: dict, config) -> dict[str, torch.Tensor]:
    """The trained clip classifier's tree (``encoder`` and the
    ``dir_head``, ``kind_head``, ``event_head`` Dense heads) → the port's
    ``ClipClassifier``."""
    params = tree["params"] if "params" in tree else tree
    out = {f"encoder.{k}": v for k, v in videomae_params_from_jax(params["encoder"],
                                                                   config).items()}
    for head in ("dir_head", "kind_head", "event_head"):
        out.update(_dense(params[head], head))
    return out


def hico_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """A Flax ``HierarchicalCompressor`` tree (``temporal_pe`` and the
    cross-attention pools it holds: ``frame_to_clip``, ``clip_to_video``)
    → the port's ``HierarchicalCompressor`` state dict."""
    params = tree["params"] if "params" in tree else tree
    out = {"temporal_pe": _tensor(params["temporal_pe"])}
    for pool in ("frame_to_clip", "clip_to_video"):
        if pool not in params:
            continue
        node = params[pool]
        out[f"{pool}.query"] = _tensor(node["query"])
        out.update(_attention(node, pool))
        out.update(_norm(node["norm"], f"{pool}.norm"))
    return out


# --------------------------------------------------------------------------
# The way back: a state dict as the JAX package's tree
# --------------------------------------------------------------------------

def _leaves(tree: dict, path: tuple = ()) -> list:
    out = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out.extend(_leaves(value, path + (key,)))
        else:
            out.append((path + (key,), value))
    return out


def tree_from_state(convert, skeleton: dict, state: dict) -> dict:
    """The JAX tree that ``convert`` (a converter of this module, with its
    other arguments bound) maps to ``state``.

    ``skeleton`` is the tree's layout: nested dicts whose leaves are shapes.
    The converters only move elements (transposes, reshapes, renames), so
    ``convert`` is run once on a tree whose every element holds its own
    address (leaf number and flat offset, exact in f64); each state tensor
    then says where its elements came from.  Raises unless every element
    of the tree is written exactly once."""
    leaves = _leaves(skeleton)
    probe: dict = {}
    for i, (path, shape) in enumerate(leaves):
        node = probe
        for part in path[:-1]:
            node = node.setdefault(part, {})
        size = int(np.prod(shape, dtype=np.int64))
        node[path[-1]] = (np.arange(size, dtype=np.float64) + i * 2.0 ** 32).reshape(shape)
    addresses = convert(probe)
    if addresses.keys() != state.keys():
        raise KeyError(f"state keys differ from the converter's: "
                       f"{sorted(set(addresses) ^ set(state))[:4]}")
    flat = [np.zeros(int(np.prod(shape, dtype=np.int64)), np.float32) for _, shape in leaves]
    seen = [np.zeros(len(f), bool) for f in flat]
    for key, where in addresses.items():
        ids = where.numpy().astype(np.int64).ravel()
        values = state[key].detach().float().cpu().numpy().ravel()
        if len(values) != len(ids):
            raise ValueError(f"{key}: {len(values)} values for {len(ids)} addresses")
        for leaf in np.unique(ids >> 32):
            pick = (ids >> 32) == leaf
            offsets = ids[pick] & 0xFFFFFFFF
            if seen[leaf][offsets].any() or len(np.unique(offsets)) != len(offsets):
                raise ValueError(f"{key}: an element of the tree is written twice")
            flat[leaf][offsets] = values[pick]
            seen[leaf][offsets] = True
    if not all(s.all() for s in seen):
        raise ValueError("the converter leaves an element of the tree unwritten")
    tree: dict = {}
    for (path, shape), values in zip(leaves, flat):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = values.reshape(shape)
    return tree
