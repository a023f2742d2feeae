"""gvl_tpu_torch's SAM ViT against gvl_tpu's and HF ``SamModel``.

A tiny random ``SamModel`` (the geometry of ``tests/test_sam_vit.py``) goes
through JAX's ``convert_hf_sam`` and the port's: image embeddings,
point- and box-prompted masks and IoU scores, and single-mask output.
Port against JAX: f32, within 1e-5 of the largest magnitude; port against
``transformers``: within 1e-4.  C16: the JAX model's two-way blocks
normalise with eps 1e-5 where HF's mask decoder has 1e-6; the port keeps
JAX's and meets ``transformers`` with HF's.  Then ``load_hf_sam`` on a
saved directory and the composite's point-grid proposals against JAX's.
"""

import os

os.environ.setdefault("USE_TF", "0")
os.environ["HF_HUB_OFFLINE"] = "1"
os.environ["TRANSFORMERS_OFFLINE"] = "1"

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gvl_tpu.models import sam_vit as jax_sam  # noqa: E402
from gvl_tpu_torch.models import sam_vit  # noqa: E402

JAX_SHARE = 1e-5
HF_SHARE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def share(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def hf_sam_config(layers: int = 3):
    from transformers import SamConfig

    return SamConfig(
        vision_config=dict(hidden_size=32, num_hidden_layers=layers, num_attention_heads=2,
                           image_size=64, patch_size=16, output_channels=16,
                           global_attn_indexes=[1], window_size=2, mlp_dim=64,
                           num_pos_feats=8),
        prompt_encoder_config=dict(hidden_size=16, image_embedding_size=4, image_size=64,
                                   patch_size=16),
        mask_decoder_config=dict(hidden_size=16, num_attention_heads=2, num_hidden_layers=2,
                                 iou_head_hidden_dim=16, mlp_dim=32))


@pytest.fixture(scope="module")
def models():
    from transformers import SamModel

    torch.manual_seed(0)
    hf = SamModel(hf_sam_config()).eval()
    sd = hf.state_dict()
    cfg = sam_vit.SamViTConfig.from_hf(hf.config)
    jcfg = jax_sam.SamViTConfig.from_hf(hf.config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    state = sam_vit.convert_hf_sam(sd, cfg)
    port = sam_vit.load_sam_vit(cfg, state, device="cpu")
    # the same weights with HF's mask-decoder eps in the two-way blocks (C16)
    hf_eps = sam_vit.load_sam_vit(cfg, state, device="cpu")
    for layer in hf_eps.decoder.layers:
        for norm in (layer.norm1, layer.norm2, layer.norm3, layer.norm4):
            norm.eps = hf.config.mask_decoder_config.layer_norm_eps
    return hf, port, hf_eps, jcfg, jax_sam.convert_hf_sam(sd, jcfg)


def jax_predict(params, pixels, config, multimask_output=True, **prompts):
    """JAX's ``sam_predict`` under ``jax.jit`` (one compile a prompt layout
    costs less here than its ops run one by one)."""
    run = jax.jit(lambda p, x, kw: jax_sam.sam_predict(
        p, x, config, multimask_output=multimask_output, **kw))
    return run(params, pixels, prompts)


def _pixels(seed, n=1):
    return np.random.RandomState(seed).randn(n, 64, 64, 3).astype(np.float32)


def test_image_embeddings_match_jax_and_hf(models):
    hf, port, _, jcfg, jparams = models
    pixels = _pixels(0, 2)
    got = port.vision(torch.from_numpy(pixels)).detach().numpy()
    want = np.asarray(jax.jit(lambda p, x: jax_sam.vision_encoder(p, x, jcfg))(
        jparams["vision"], jnp.asarray(pixels)))
    with torch.no_grad():
        ref = hf.vision_encoder(torch.tensor(pixels.transpose(0, 3, 1, 2))).last_hidden_state
    assert got.shape == (2, 4, 4, 16)
    assert share(got, want) <= JAX_SHARE
    assert share(got, ref.numpy().transpose(0, 2, 3, 1)) <= HF_SHARE


PROMPTS = {
    "points": dict(input_points=np.array([[[[20.0, 30.0], [45.0, 10.0]]]], np.float32),
                   input_labels=np.array([[[1, 0]]], np.int64)),
    "boxes": dict(input_boxes=np.array([[[8.0, 8.0, 40.0, 48.0]]], np.float32)),
    "points and boxes": dict(input_points=np.array([[[[20.0, 30.0]]]], np.float32),
                             input_labels=np.array([[[1]]], np.int64),
                             input_boxes=np.array([[[8.0, 8.0, 40.0, 48.0]]], np.float32)),
}


@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_prompted_masks_match_jax_and_hf(models, prompt):
    hf, port, hf_eps, jcfg, jparams = models
    pixels = _pixels(1)
    kw = PROMPTS[prompt]
    got_masks, got_iou = sam_vit.sam_predict(
        port, torch.from_numpy(pixels), **{k: torch.from_numpy(v) for k, v in kw.items()})
    want_masks, want_iou = jax_predict(
        jparams, jnp.asarray(pixels), jcfg, **{k: jnp.asarray(v) for k, v in kw.items()})
    assert got_masks.shape == (1, 1, 3, 16, 16) and got_iou.shape == (1, 1, 3)
    assert share(got_masks, want_masks) <= JAX_SHARE
    assert share(got_iou, want_iou) <= JAX_SHARE

    with torch.no_grad():
        ref = hf(pixel_values=torch.tensor(pixels.transpose(0, 3, 1, 2)), multimask_output=True,
                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    masks, iou = sam_vit.sam_predict(
        hf_eps, torch.from_numpy(pixels), **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert share(masks, ref.pred_masks) <= HF_SHARE
    assert share(iou, ref.iou_scores) <= HF_SHARE


def test_c16_the_jax_decoder_eps_parts_from_hf(models):
    """C16: with JAX's eps (the port's) the masks stand further from
    ``transformers`` than with HF's, and only the two-way blocks' norms differ."""
    hf, port, hf_eps, _, _ = models
    pixels, kw = _pixels(1), PROMPTS["points"]
    with torch.no_grad():
        ref = hf(pixel_values=torch.tensor(pixels.transpose(0, 3, 1, 2)), multimask_output=True,
                 **{k: torch.from_numpy(v) for k, v in kw.items()}).pred_masks
    args = (torch.from_numpy(pixels), torch.from_numpy(kw["input_points"]),
            torch.from_numpy(kw["input_labels"]))
    jax_eps_share = share(sam_vit.sam_predict(port, *args)[0], ref)
    assert jax_eps_share > 10 * share(sam_vit.sam_predict(hf_eps, *args)[0], ref)
    assert [m.eps for m in port.decoder.modules() if isinstance(m, torch.nn.LayerNorm)] == \
        [1e-5] * 8 + [1e-5, 1e-6]   # blocks' norm1-4, final norm, upscaler
    assert hf.mask_decoder.transformer.layers[0].layer_norm1.eps == 1e-6
    assert sam_vit.DECODER_LN_EPS == 1e-5


def test_single_mask_output_matches_jax(models):
    _, port, _, jcfg, jparams = models
    pixels = _pixels(3)
    points = np.array([[[[32.0, 32.0]]]], np.float32)
    labels = np.array([[[1]]], np.int64)
    got_masks, got_iou = sam_vit.sam_predict(
        port, torch.from_numpy(pixels), torch.from_numpy(points), torch.from_numpy(labels),
        multimask_output=False)
    want_masks, want_iou = jax_predict(
        jparams, jnp.asarray(pixels), jcfg, multimask_output=False,
        input_points=jnp.asarray(points), input_labels=jnp.asarray(labels))
    assert got_masks.shape[2] == 1 and got_iou.shape[2] == 1
    assert share(got_masks, want_masks) <= JAX_SHARE
    assert share(got_iou, want_iou) <= JAX_SHARE


def test_load_hf_sam_reads_a_saved_directory(tmp_path, models):
    hf = models[0]
    hf.save_pretrained(tmp_path)
    cfg, state = sam_vit.load_hf_sam(tmp_path)
    assert cfg == sam_vit.SamViTConfig.from_hf(hf.config)
    want = sam_vit.convert_hf_sam(hf.state_dict(), cfg)
    assert state.keys() == want.keys() == sam_vit.SamViT(cfg).state_dict().keys()
    assert all(torch.equal(state[k], want[k]) for k in want)


def test_point_grid_proposals_match_jax(models):
    """The composite's SAM proposer: a 2 x 2 point grid on uint8 frames of
    another size, each point's best mask and its IoU, against JAX's."""
    from gvl_tpu.perception.open_vocab import OpenVocabSamBackend as JaxBackend
    from gvl_tpu_torch.perception.open_vocab import OpenVocabSamBackend

    _, port, _, jcfg, jparams = models
    frames = list(np.random.default_rng(4).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8))
    got = OpenVocabSamBackend(port.config, port, None, None, None, None, grid=2)
    want = JaxBackend(jcfg, jparams, None, None, None, None, grid=2)   # no towers needed
    np.testing.assert_array_equal(got._points, want._points)
    got_masks, got_iou = got._proposals(frames)
    want_masks, want_iou = want._proposals(frames)
    assert got_masks.shape == (2, 4, 16, 16) and got_masks.dtype == bool
    np.testing.assert_array_equal(got_masks, want_masks)
    assert share(got_iou, want_iou) <= JAX_SHARE
