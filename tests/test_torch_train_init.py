"""The perception trainers' from-scratch initialiser
(``gvl_tpu_torch.training.init_laws``) against the JAX package's
``model.init`` for each of the eight models, at widths where leaves reach
2^15 values: the same tree (paths and shapes), per-leaf standard deviation
within 3 % on every leaf of at least 2^15 values, the truncated laws
(``lecun_normal``, ``he_normal``) inside their bound of two standard
deviations of the untruncated normal, and the deterministic leaves
(zero biases, unit scales, SigLIP's constants) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu_torch.training import init_laws

from torch_train_helpers import one_torch_thread  # noqa: F401

STD_SHARE = 0.03
MIN_VALUES = 2 ** 15


def _init(module, *args):
    """``module.init`` jitted: eager initialisation runs the model's
    forward op by op, several times slower."""
    return jax.jit(module.init)(jax.random.PRNGKey(0), *args)


def _sam():
    from gvl_tpu.models.sam import PromptableSegmenter, SamConfig

    cfg = SamConfig(image_size=64, encoder_dim=128, encoder_layers=1, encoder_heads=2,
                    text_dim=64, text_layers=1, decoder_dim=128, decoder_layers=1)
    tree = _init(PromptableSegmenter(cfg), jnp.zeros((1, 64, 64, 3)),
                 jnp.zeros((4, 16), jnp.int32))
    return tree, init_laws.sam_layout(cfg)


def _whisper():
    from gvl_tpu.models.whisper import WhisperModel
    from gvl_tpu.training.asr_train import asr_config

    cfg = asr_config(d_model=128, encoder_layers=1, decoder_layers=1, num_heads=2, ffn_dim=512)
    tree = _init(WhisperModel(cfg), jnp.zeros((1, 600, 80)),
                 jnp.zeros((1, 4), jnp.int32))["params"]
    return tree, init_laws.whisper_layout(cfg)


def _minisiglip():
    from gvl_tpu.training import siglip_train as js

    vc = js.minisiglip_vision_config(hidden_size=128, intermediate_size=256, num_layers=1,
                                     num_heads=2, image_size=64)
    tc = js.minisiglip_text_config(hidden_size=128, intermediate_size=256, num_layers=1,
                                   num_heads=2, projection_size=128)
    tree = _init(js.MiniSigLIP(vc, tc), jnp.zeros((1, 64, 64, 3)),
                 jnp.zeros((1, 32), jnp.int32))["params"]
    return tree, init_laws.minisiglip_layout(vc, tc)


def _videomae():
    from gvl_tpu.training import videomae_train as jv

    cfg = jv.mini_videomae_config(hidden_size=128, intermediate_size=256, num_layers=1,
                                  num_heads=2, image_size=32, num_frames=4)
    tree = _init(jv.build_classifier(cfg), jnp.zeros((1, 4, 32, 32, 3)))["params"]
    return tree, init_laws.clip_classifier_layout(cfg, (9, 4, 3))


def _hico():
    from gvl_tpu.temporal.hico import HiCoConfig
    from gvl_tpu.training.hico_train import _TrainWrapper

    cfg = HiCoConfig(hidden_dim=256, num_heads=2)
    tree = _init(_TrainWrapper(cfg, 4, 2), jnp.zeros((1, 4, 256)))["params"]["compressor"]
    return tree, init_laws.hico_layout(cfg)


def _ocr(net):
    def build():
        from gvl_tpu.perception import ocr_model as jo
        from gvl_tpu_torch.perception import ocr_model as to

        cfg = to.OCRModelConfig(rec_arch="v2")
        jnet = jo.make_recognizer(jo.OCRModelConfig(rec_arch="v2")) if net == "rec" else \
            jo.TextDetectorNet(jo.OCRModelConfig())
        shape = (1, 32, 192, 1) if net == "rec" else (1, 256, 448, 1)
        tree = _init(jnet, jnp.zeros(shape))
        with torch.device("meta"):
            tnet = to.make_recognizer(cfg) if net == "rec" else to.TextDetectorNet(cfg)
        return tree, init_laws.named_net_layout(tnet, cfg.v2_heads)
    return build


def _events():
    from gvl_tpu.audio import event_model as je
    from gvl_tpu_torch.audio import event_model as te

    cfg = je.EventModelConfig()
    tree = _init(je.AudioEventNet(cfg), jnp.zeros((1, cfg.n_frames, 80)), jnp.zeros((1,)))
    with torch.device("meta"):
        return tree, init_laws.named_net_layout(te.AudioEventNet(te.EventModelConfig()))


def _paths(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("build", [_sam, _whisper, _minisiglip, _videomae, _hico, _ocr("rec"),
                                   _ocr("det"), _events],
                         ids=["segmenter", "asr", "minisiglip", "videomae", "hico",
                              "ocr_recognizer", "ocr_detector", "audio_events"])
def test_initialiser_follows_the_jax_laws(build):
    want_tree, layout = build()
    got, want = (_paths(init_laws.draw_tree(layout, torch.Generator().manual_seed(0))),
                 _paths(want_tree))
    assert got.keys() == want.keys()
    leaves = dict(init_laws._leaves(layout))
    big = 0
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == np.float32, path
        if np.all(w == w.ravel()[0]):            # zeros, ones, constants
            assert np.array_equal(g, w), path
            continue
        if w.size >= MIN_VALUES:
            big += 1
            assert abs(g.std() / w.std() - 1.0) <= STD_SHARE, (path, g.std(), w.std())
        spec = leaves[path]
        law = spec.law if isinstance(spec, init_laws.Leaf) else (
            "lecun" if path[-1] == "kernel" else "normal")
        if law in ("lecun", "he"):
            fan_in = (spec.arg if isinstance(spec, init_laws.Leaf) and spec.arg
                      else int(np.prod(w.shape[:-1])))
            bound = 2 * np.sqrt((2.0 if law == "he" else 1.0) / fan_in) / 0.87962566103423978
            assert np.abs(g).max() <= bound * (1 + 1e-6), path
            assert np.abs(w).max() <= bound * (1 + 1e-6), path
    # the detector's widths (16/32/32) give no leaf of 2^15 values
    assert big >= 1 or build.__name__ == "build" and got[("params", "Conv_2", "kernel")].size < MIN_VALUES
