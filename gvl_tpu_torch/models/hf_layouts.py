"""The HF checkpoint layouts of the perception models, and seeded weights in
them.

Each ``*_layout(config)`` gives the names and shapes of the tensors a HF
checkpoint of that model holds for the port's ``config`` (the
``state_dict()`` of ``BertModel`` without its pooler, ``Wav2Vec2Model``,
``WhisperModel``, ``VideoMAEModel``, ``SiglipVisionModel``,
``SiglipTextModel`` and ``SamModel``), without ``transformers``; the tests
hold them to ``transformers`` at small configs.  :func:`random_state` draws
such a state dict from a ``torch.Generator``, which the port's
``convert_hf_*`` then read: what runs the models at their published
geometry where no checkpoint is (``chip_smoke.py`` phase 17).
"""

from __future__ import annotations

import math

import torch

from gvl_tpu_torch import resolve_device

Layout = dict[str, tuple[int, ...]]


def _linear(out: Layout, name: str, n_out: int, n_in: int, bias: bool = True) -> None:
    out[f"{name}.weight"] = (n_out, n_in)
    if bias:
        out[f"{name}.bias"] = (n_out,)


def _norm(out: Layout, name: str, dim: int) -> None:
    out[f"{name}.weight"] = (dim,)
    out[f"{name}.bias"] = (dim,)


def bert_layout(config) -> Layout:
    """``BertModel(add_pooling_layer=False)`` for a ``MiniLMConfig``."""
    d, out = config.hidden_size, {}
    out["embeddings.word_embeddings.weight"] = (config.vocab_size, d)
    out["embeddings.position_embeddings.weight"] = (config.max_position, d)
    out["embeddings.token_type_embeddings.weight"] = (config.type_vocab_size, d)
    _norm(out, "embeddings.LayerNorm", d)
    for i in range(config.num_layers):
        pre = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            _linear(out, f"{pre}.attention.self.{name}", d, d)
        _linear(out, f"{pre}.attention.output.dense", d, d)
        _norm(out, f"{pre}.attention.output.LayerNorm", d)
        _linear(out, f"{pre}.intermediate.dense", config.intermediate_size, d)
        _linear(out, f"{pre}.output.dense", d, config.intermediate_size)
        _norm(out, f"{pre}.output.LayerNorm", d)
    return out


def wav2vec2_layout(config) -> Layout:
    """``Wav2Vec2Model`` for a ``Wav2Vec2Config`` (with its
    ``masked_spec_embed``, as HF's default masking probabilities keep it)."""
    d, out = config.hidden_size, {"masked_spec_embed": (config.hidden_size,)}
    dims = (1, *config.conv_dim)
    for i, k in enumerate(config.conv_kernel):
        pre = f"feature_extractor.conv_layers.{i}"
        out[f"{pre}.conv.weight"] = (dims[i + 1], dims[i], k)
        if config.conv_bias:
            out[f"{pre}.conv.bias"] = (dims[i + 1],)
        if config.feat_extract_norm == "layer" or i == 0:
            _norm(out, f"{pre}.layer_norm", dims[i + 1])
    _norm(out, "feature_projection.layer_norm", dims[-1])
    _linear(out, "feature_projection.projection", d, dims[-1])
    k, groups = config.num_conv_pos_embeddings, config.num_conv_pos_embedding_groups
    out["encoder.pos_conv_embed.conv.bias"] = (d,)
    out["encoder.pos_conv_embed.conv.parametrizations.weight.original0"] = (1, 1, k)
    out["encoder.pos_conv_embed.conv.parametrizations.weight.original1"] = (d, d // groups, k)
    _norm(out, "encoder.layer_norm", d)
    for i in range(config.num_layers):
        pre = f"encoder.layers.{i}"
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            _linear(out, f"{pre}.attention.{name}", d, d)
        _norm(out, f"{pre}.layer_norm", d)
        _linear(out, f"{pre}.feed_forward.intermediate_dense", config.intermediate_size, d)
        _linear(out, f"{pre}.feed_forward.output_dense", d, config.intermediate_size)
        _norm(out, f"{pre}.final_layer_norm", d)
    return out


def whisper_layout(config) -> Layout:
    """``WhisperModel`` for a ``WhisperConfig``."""
    d, out = config.d_model, {}

    def attention(pre):
        _linear(out, f"{pre}.k_proj", d, d, bias=False)
        for name in ("v_proj", "q_proj", "out_proj"):
            _linear(out, f"{pre}.{name}", d, d)

    def feed_forward(pre):
        _linear(out, f"{pre}.fc1", config.ffn_dim, d)
        _linear(out, f"{pre}.fc2", d, config.ffn_dim)
        _norm(out, f"{pre}.final_layer_norm", d)

    out["encoder.conv1.weight"], out["encoder.conv1.bias"] = (d, config.num_mel_bins, 3), (d,)
    out["encoder.conv2.weight"], out["encoder.conv2.bias"] = (d, d, 3), (d,)
    out["encoder.embed_positions.weight"] = (config.max_source_positions, d)
    for i in range(config.encoder_layers):
        pre = f"encoder.layers.{i}"
        attention(f"{pre}.self_attn")
        _norm(out, f"{pre}.self_attn_layer_norm", d)
        feed_forward(pre)
    _norm(out, "encoder.layer_norm", d)
    out["decoder.embed_tokens.weight"] = (config.vocab_size, d)
    out["decoder.embed_positions.weight"] = (config.max_target_positions, d)
    for i in range(config.decoder_layers):
        pre = f"decoder.layers.{i}"
        attention(f"{pre}.self_attn")
        _norm(out, f"{pre}.self_attn_layer_norm", d)
        attention(f"{pre}.encoder_attn")
        _norm(out, f"{pre}.encoder_attn_layer_norm", d)
        feed_forward(pre)
    _norm(out, "decoder.layer_norm", d)
    return out


def videomae_layout(config, channels: int = 3) -> Layout:
    """``VideoMAEModel`` (mean pooling, so no final norm) for a
    ``VideoMAEConfig``."""
    d, p, out = config.hidden_size, config.patch_size, {}
    out["embeddings.patch_embeddings.projection.weight"] = (d, channels, config.tubelet_size, p, p)
    out["embeddings.patch_embeddings.projection.bias"] = (d,)
    for i in range(config.num_layers):
        pre = f"encoder.layer.{i}"
        out[f"{pre}.attention.attention.q_bias"] = (d,)
        out[f"{pre}.attention.attention.v_bias"] = (d,)
        for name in ("query", "key", "value"):
            out[f"{pre}.attention.attention.{name}.weight"] = (d, d)
        _linear(out, f"{pre}.attention.output.dense", d, d)
        _linear(out, f"{pre}.intermediate.dense", config.intermediate_size, d)
        _linear(out, f"{pre}.output.dense", d, config.intermediate_size)
        _norm(out, f"{pre}.layernorm_before", d)
        _norm(out, f"{pre}.layernorm_after", d)
    return out


def _siglip_blocks(out: Layout, pre: str, d: int, inner: int, num_layers: int) -> None:
    for i in range(num_layers):
        layer = f"{pre}.encoder.layers.{i}"
        _norm(out, f"{layer}.layer_norm1", d)
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            _linear(out, f"{layer}.self_attn.{name}", d, d)
        _norm(out, f"{layer}.layer_norm2", d)
        _linear(out, f"{layer}.mlp.fc1", inner, d)
        _linear(out, f"{layer}.mlp.fc2", d, inner)


def siglip_vision_layout(config, channels: int = 3) -> Layout:
    """``SiglipVisionModel`` (with its MAP head) for a ``SigLIPVisionConfig``."""
    d, p, inner, out = config.hidden_size, config.patch_size, config.intermediate_size, {}
    out["vision_model.embeddings.patch_embedding.weight"] = (d, channels, p, p)
    out["vision_model.embeddings.patch_embedding.bias"] = (d,)
    out["vision_model.embeddings.position_embedding.weight"] = (config.num_patches, d)
    _siglip_blocks(out, "vision_model", d, inner, config.num_layers)
    _norm(out, "vision_model.post_layernorm", d)
    out["vision_model.head.probe"] = (1, 1, d)
    out["vision_model.head.attention.in_proj_weight"] = (3 * d, d)
    out["vision_model.head.attention.in_proj_bias"] = (3 * d,)
    _linear(out, "vision_model.head.attention.out_proj", d, d)
    _norm(out, "vision_model.head.layernorm", d)
    _linear(out, "vision_model.head.mlp.fc1", inner, d)
    _linear(out, "vision_model.head.mlp.fc2", d, inner)
    return out


def siglip_text_layout(config) -> Layout:
    """``SiglipTextModel`` for a ``SigLIPTextConfig``."""
    d, out = config.hidden_size, {}
    out["text_model.embeddings.token_embedding.weight"] = (config.vocab_size, d)
    out["text_model.embeddings.position_embedding.weight"] = (config.max_position, d)
    _siglip_blocks(out, "text_model", d, config.intermediate_size, config.num_layers)
    _norm(out, "text_model.final_layer_norm", d)
    _linear(out, "text_model.head", config.projection_size, d)
    return out


def sam_layout(config, mask_in_chans: int = 16) -> Layout:
    """``SamModel`` for a ``SamViTConfig`` (its dense-mask embedding at HF's
    default ``mask_input_channels`` included, though no port path reads it)."""
    d, c, side, out = config.hidden_size, config.prompt_hidden, config.embed_side, {}
    out["shared_image_embedding.positional_embedding"] = (2, config.num_pos_feats)
    vis = "vision_encoder"
    out[f"{vis}.pos_embed"] = (1, side, side, d)
    out[f"{vis}.patch_embed.projection.weight"] = (d, 3, config.patch_size, config.patch_size)
    out[f"{vis}.patch_embed.projection.bias"] = (d,)
    head = d // config.num_heads
    for i in range(config.num_layers):
        pre = f"{vis}.layers.{i}"
        size = side if i in config.global_attn_indexes else config.window_size
        _norm(out, f"{pre}.layer_norm1", d)
        out[f"{pre}.attn.rel_pos_h"] = out[f"{pre}.attn.rel_pos_w"] = (2 * size - 1, head)
        _linear(out, f"{pre}.attn.qkv", 3 * d, d)
        _linear(out, f"{pre}.attn.proj", d, d)
        _norm(out, f"{pre}.layer_norm2", d)
        _linear(out, f"{pre}.mlp.lin1", config.mlp_dim, d)
        _linear(out, f"{pre}.mlp.lin2", d, config.mlp_dim)
    oc = config.output_channels
    out[f"{vis}.neck.conv1.weight"] = (oc, d, 1, 1)
    _norm(out, f"{vis}.neck.layer_norm1", oc)
    out[f"{vis}.neck.conv2.weight"] = (oc, oc, 3, 3)
    _norm(out, f"{vis}.neck.layer_norm2", oc)

    pe = "prompt_encoder"
    out[f"{pe}.shared_embedding.positional_embedding"] = (2, config.num_pos_feats)
    q = mask_in_chans // 4
    out[f"{pe}.mask_embed.conv1.weight"], out[f"{pe}.mask_embed.conv1.bias"] = (q, 1, 2, 2), (q,)
    out[f"{pe}.mask_embed.conv2.weight"] = (mask_in_chans, q, 2, 2)
    out[f"{pe}.mask_embed.conv2.bias"] = (mask_in_chans,)
    out[f"{pe}.mask_embed.conv3.weight"] = (c, mask_in_chans, 1, 1)
    out[f"{pe}.mask_embed.conv3.bias"] = (c,)
    _norm(out, f"{pe}.mask_embed.layer_norm1", q)
    _norm(out, f"{pe}.mask_embed.layer_norm2", mask_in_chans)
    out[f"{pe}.no_mask_embed.weight"] = (1, c)
    for i in range(4):
        out[f"{pe}.point_embed.{i}.weight"] = (1, c)
    out[f"{pe}.not_a_point_embed.weight"] = (1, c)

    dec, tr = "mask_decoder", "mask_decoder.transformer"
    masks = config.num_multimask_outputs + 1
    out[f"{dec}.iou_token.weight"] = (1, c)
    out[f"{dec}.mask_tokens.weight"] = (masks, c)

    def attention(pre, inner):
        for name in ("q_proj", "k_proj", "v_proj"):
            _linear(out, f"{pre}.{name}", inner, c)
        _linear(out, f"{pre}.out_proj", c, inner)

    down = c // config.attention_downsample_rate
    for i in range(config.decoder_layers):
        pre = f"{tr}.layers.{i}"
        attention(f"{pre}.self_attn", c)
        _norm(out, f"{pre}.layer_norm1", c)
        attention(f"{pre}.cross_attn_token_to_image", down)
        _norm(out, f"{pre}.layer_norm2", c)
        _linear(out, f"{pre}.mlp.lin1", config.decoder_mlp_dim, c)
        _linear(out, f"{pre}.mlp.lin2", c, config.decoder_mlp_dim)
        _norm(out, f"{pre}.layer_norm3", c)
        _norm(out, f"{pre}.layer_norm4", c)
        attention(f"{pre}.cross_attn_image_to_token", down)
    attention(f"{tr}.final_attn_token_to_image", down)
    _norm(out, f"{tr}.layer_norm_final_attn", c)
    out[f"{dec}.upscale_conv1.weight"], out[f"{dec}.upscale_conv1.bias"] = \
        (c, c // 4, 2, 2), (c // 4,)
    out[f"{dec}.upscale_conv2.weight"], out[f"{dec}.upscale_conv2.bias"] = \
        (c // 4, c // 8, 2, 2), (c // 8,)
    _norm(out, f"{dec}.upscale_layer_norm", c // 4)

    def feed_forward(pre, hidden, n_out, depth):
        _linear(out, f"{pre}.proj_in", hidden, c)
        _linear(out, f"{pre}.proj_out", n_out, hidden)
        for j in range(depth - 2):
            _linear(out, f"{pre}.layers.{j}", hidden, hidden)

    for i in range(masks):
        feed_forward(f"{dec}.output_hypernetworks_mlps.{i}", c, c // 8, 3)
    feed_forward(f"{dec}.iou_prediction_head", config.iou_head_hidden, masks,
                 config.iou_head_depth)
    return out


_NORM_NAMES = ("norm", "LayerNorm")


def random_state(layout: Layout, generator: torch.Generator,
                 device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """f32 tensors of ``layout`` drawn from ``generator`` on ``device`` in the
    layout's order: norm scales 1, other vectors 0 (biases), every other
    tensor ``N(0, 1/fan_in)`` with fan_in its size over its first axis
    (weights, convolutions, embeddings and position tables alike)."""
    device = resolve_device(device)
    state = {}
    for name, shape in layout.items():
        w = torch.empty(shape, dtype=torch.float32, device=device)
        if len(shape) == 1:
            w.fill_(1.0 if name.endswith(".weight") and any(
                n in name for n in _NORM_NAMES) else 0.0)
        else:
            w.normal_(0.0, 1.0 / math.sqrt(math.prod(shape[1:])), generator=generator)
        state[name] = w
    return state
