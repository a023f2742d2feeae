"""gvl_tpu_torch's Qwen3-VL against gvl_tpu's, on the CPU, in f32.

JAX's tiny HF pair (``tests/test_qwen3vl.py``: a random
``Qwen3VLForConditionalGeneration`` with a 2-block tower and a 2-layer
decoder) converted by both packages: the host math, the tower and its
DeepStack features, logits with and without an image, greedy generation
(f32 cache, as JAX's), the converters key for key, ``ReasoningCore`` over
``Qwen3VLChatBackend`` and ``create_reasoning_core(vl_checkpoint_path=)``,
and the port's copy of Pillow's bilinear resize byte for byte.  Also the
settled divergences: C9 (the tower attends across temporal frames as JAX's
does, HF's within each) and C10 (DeepStack under ``scan_layers`` raises).
"""

import os

os.environ.setdefault("USE_TF", "0")   # transformers need not import TensorFlow (5 s)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gvl_tpu.models import qwen3vl as jvl  # noqa: E402
from gvl_tpu_torch.models import qwen3vl as tvl  # noqa: E402
from gvl_tpu_torch.models.convert import qwen3vl_params_from_jax  # noqa: E402
from gvl_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model  # noqa: E402
from gvl_tpu_torch.runtime.resize import pil_bilinear  # noqa: E402

from test_qwen3vl import GRID, MROPE_SECTION, make_inputs, tiny_hf_model  # noqa: E402

TOWER_ATOL = 1e-5
LOGITS_ATOL = 1e-4
MROPE_ATOL = 1e-6
GRIDS = [(1, 4, 4), (1, 4, 6), (2, 4, 4)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trio():
    """(HF model, JAX Qwen3VL, the port's Qwen3VL on the CPU) on one set of
    weights; the port converts HF's state dict itself."""
    hf = tiny_hf_model()
    vision_cfg, text_cfg, params = jvl.convert_hf_qwen3vl(hf)
    want = jvl.Qwen3VL(vision_cfg, text_cfg, params, image_token_id=7,
                       mrope_section=MROPE_SECTION)
    tv, tt, state = tvl.convert_hf_qwen3vl(hf)
    got = tvl.Qwen3VL(tv, tt, state, image_token_id=7, mrope_section=MROPE_SECTION,
                      device="cpu")
    return hf, want, got


@pytest.fixture(scope="module")
def jax_towers(trio):
    """JAX's tower outputs at each of GRIDS, computed once (jitted: the
    first eager call compiles every op, three times slower)."""
    vl = trio[1]
    out = {}
    for grid in GRIDS:
        tower = jax.jit(lambda v, x, g=grid: vl.vision.apply({"params": v}, x, g))
        out[grid] = tower(vl.variables["vision"], _patches(grid))
    return out


def _patches(grid, seed=0):
    cfg = tvl.Qwen3VLVisionConfig.tiny()
    return np.random.RandomState(seed).randn(int(np.prod(grid)), cfg.patch_dim).astype(
        np.float32)


@pytest.mark.parametrize("grid", GRIDS + [(3, 8, 6)])
def test_host_math_equals_jax(grid):
    """The four host functions exactly, and the mRoPE tables within 1e-6."""
    for cfg in (tvl.Qwen3VLVisionConfig.tiny(), tvl.Qwen3VLVisionConfig()):
        jcfg = jvl.Qwen3VLVisionConfig(**cfg.__dict__)
        for name in ("interpolated_pos_indices", "vision_rope_table"):
            for a, b in zip(getattr(tvl, name)(cfg, grid), getattr(jvl, name)(jcfg, grid)):
                assert a.dtype == b.dtype and np.array_equal(a, b), name
    cfg = tvl.Qwen3VLVisionConfig.tiny()
    frames = np.random.RandomState(1).randint(0, 256, (2 * grid[0] - 1, 16 * grid[1],
                                                       16 * grid[2], 3)).astype(np.uint8)
    got, got_grid = tvl.patchify_frames(frames, cfg)
    want, want_grid = jvl.patchify_frames(frames, jvl.Qwen3VLVisionConfig.tiny())
    assert got_grid == want_grid == tuple(grid) and np.array_equal(got, want)
    n_vis = int(np.prod(grid)) // 4
    ids = np.array([[11, 12, 5] + [7] * n_vis + [6, 13, 14, 15],
                    [20, 5] + [7] * n_vis + [6, 21, 22, 23, 24]], np.int64)
    pos = tvl.vl_position_ids(ids, grid, image_token_id=7)
    assert np.array_equal(pos, jvl.vl_position_ids(ids, grid, image_token_id=7))
    for head_dim, theta, section in ((16, 10000.0, MROPE_SECTION),
                                     (128, 1_000_000.0, (24, 20, 20))):
        cos, sin = tvl.mrope_cos_sin(torch.from_numpy(pos), head_dim, theta, section)
        jcos, jsin = jvl.mrope_cos_sin(jax.numpy.asarray(pos), head_dim, theta, section)
        assert cos.dtype == torch.float32 and cos.shape == (2, ids.shape[1], head_dim)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=MROPE_ATOL, rtol=0)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=MROPE_ATOL, rtol=0)


def test_converters_agree_key_for_key(trio):
    """``convert_hf_qwen3vl`` equals ``qwen3vl_params_from_jax`` of JAX's
    conversion, key for key; the configs carry every JAX field."""
    hf, want, got = trio
    vision_cfg, text_cfg, params = jvl.convert_hf_qwen3vl(hf)
    tv, tt, state = tvl.convert_hf_qwen3vl(hf)
    assert tv.__dict__ == vision_cfg.__dict__
    assert {f: getattr(tt, f) for f in text_cfg.__dataclass_fields__} == text_cfg.__dict__
    carried = qwen3vl_params_from_jax(jax.tree.map(np.asarray, params), tv, tt)
    assert state.keys() == carried.keys()
    for key in state:
        assert torch.equal(state[key], carried[key]), key
    names = {f"vision.{k}" for k in got.vision.state_dict()} | {
        f"text.{k}" for k in got.text.state_dict()}
    assert names == set(state)


@pytest.mark.parametrize("grid", GRIDS)
def test_tower_matches_jax(trio, jax_towers, grid):
    """Merged embeddings and the DeepStack features within 1e-5."""
    w_out, w_deep = jax_towers[grid]
    g_out, g_deep = trio[2].encode_vision(_patches(grid), grid)
    assert g_out.shape == (int(np.prod(grid)) // 4, 48) and len(g_deep) == len(w_deep) == 2
    np.testing.assert_allclose(g_out.numpy(), np.asarray(w_out), atol=TOWER_ATOL, rtol=0)
    for g, w in zip(g_deep, w_deep):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOWER_ATOL, rtol=0)


def test_tower_attends_across_frames_as_jax_does(trio, jax_towers):
    """C9: at one temporal frame the port, JAX and HF agree; at two, HF
    attends within each frame (``cu_seqlens``) and stands apart, while the
    port stays with JAX."""
    hf, _, got = trio
    gaps = {}
    for grid in ((1, 4, 4), (2, 4, 4)):
        patches = _patches(grid)
        with torch.no_grad():
            ref, _ = hf.model.visual(torch.from_numpy(patches),
                                     grid_thw=torch.tensor([list(grid)]))
        mine, _ = got.encode_vision(patches, grid)
        theirs, _ = jax_towers[grid]
        gaps[grid] = (np.abs(mine.numpy() - np.asarray(theirs)).max(),
                      np.abs(mine.numpy() - ref.numpy()).max())
    assert gaps[(1, 4, 4)][0] < TOWER_ATOL and gaps[(1, 4, 4)][1] < TOWER_ATOL
    assert gaps[(2, 4, 4)][0] < TOWER_ATOL and gaps[(2, 4, 4)][1] > 1e-4


def test_logits_match_jax(trio):
    """Multimodal and text-only logits within 1e-4 of JAX's; the pixels
    move them."""
    _, want, got = trio
    patches, ids = make_inputs()
    mm = got.forward(ids, patches, GRID)
    np.testing.assert_allclose(mm.numpy(), np.asarray(want.forward(ids, patches, GRID)),
                               atol=LOGITS_ATOL, rtol=0)
    text = np.array([[11, 12, 13, 14, 15]], np.int64)
    np.testing.assert_allclose(got.forward(text).numpy(), np.asarray(want.forward(text)),
                               atol=LOGITS_ATOL, rtol=0)
    other = got.forward(ids, patches + 3.0, GRID)
    assert not torch.allclose(mm, other)


def test_greedy_generate_matches_jax_and_hf(trio):
    """Greedy tokens (f32 cache) equal to JAX's and to HF's ``generate``;
    no step runs after the last token."""
    hf, want, got = trio
    patches, ids = make_inputs()
    with torch.no_grad():
        ref = hf.generate(input_ids=torch.from_numpy(ids),
                          pixel_values=torch.from_numpy(patches),
                          image_grid_thw=torch.tensor([list(GRID)]),
                          max_new_tokens=6, do_sample=False, eos_token_id=None,
                          pad_token_id=0)[0, ids.shape[1]:].tolist()
    jax_out = want.generate(ids, patches, GRID, max_new_tokens=6, temperature=0.0,
                            eos_token_id=-1)
    out = got.generate(ids, patches, GRID, max_new_tokens=6, temperature=0.0,
                       eos_token_id=-1, cache_dtype=torch.float32)
    assert out == jax_out == ref
    assert got.last_decode_steps == 5
    # the default bf16 cache runs on the CPU too (the plain versions)
    assert len(got.generate(ids, patches, GRID, max_new_tokens=3, eos_token_id=-1)) == 3
    with pytest.raises(ValueError, match="batch 1"):
        got.generate(np.concatenate([ids, ids]), patches, GRID)


def test_sampled_generate_follows_its_generator(trio):
    """Temperature above 0: the tokens are drawn from the explicit
    generator, the same seed giving the same stream, in ``generate`` and
    through the backend's ``generator``."""
    from gvl_tpu_torch.agent import ReasoningCoreConfig, Qwen3VLChatBackend

    _, _, got = trio
    patches, ids = make_inputs()

    def sample(seed):
        return got.generate(ids, patches, GRID, max_new_tokens=8, temperature=1.0,
                            top_p=1.0, top_k=0, eos_token_id=-1,
                            generator=torch.Generator().manual_seed(seed))

    first = sample(0)
    assert first == sample(0) and len(first) == 8
    assert any(sample(seed) != first for seed in (1, 2, 3))
    cfg = ReasoningCoreConfig(max_new_tokens=8, temperature=1.0, top_p=1.0, top_k=0)
    streams = []
    for _ in range(2):
        backend = Qwen3VLChatBackend(got, _HashIds(), image_token_id=7, vision_start_id=5,
                                     vision_end_id=6, eos_token_id=-1, image_size=64,
                                     generator=torch.Generator().manual_seed(4))
        list(backend.stream([{"role": "user", "content": "what now?"}], cfg))
        streams.append(backend.last_tokens)
    assert streams[0] == streams[1] and len(streams[0]) == 8


def test_deepstack_needs_the_unrolled_stack():
    """C10: JAX's ``scan_layers`` stack drops DeepStack silently; the port's
    raises, and so does a Qwen3VL on a stacked decoder."""
    cfg = Qwen3Config.tiny(scan_layers=True)
    model = Qwen3Model(cfg).eval()
    x = torch.zeros(1, 4, cfg.hidden_size)
    with pytest.raises(ValueError, match="C10"):
        model(inputs_embeds=x, deepstack_embeds=torch.zeros(2, 1, 4, cfg.hidden_size))
    with pytest.raises(ValueError, match="C10"):
        model(inputs_embeds=x, rope_cos_sin=(torch.ones(1, 4, 16), torch.zeros(1, 4, 16)))
    with pytest.raises(ValueError, match="unrolled"):
        tvl.Qwen3VL(tvl.Qwen3VLVisionConfig.tiny(), cfg, {}, device="cpu")


class _HashIds:
    """A tokenizer shared by both packages' backends (JAX's test's): the
    prompt's first 48 hashed words, as ids 10-499 (clear of the tiny
    model's image and vision-span ids)."""

    def encode(self, text):
        from gvl_tpu_torch.models.sam import hash_tokenize

        return [10 + int(x) for x in hash_tokenize(text, 490, 48) if x != 0]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{i}" for i in ids)


def _frames():
    rng = np.random.RandomState(5)
    return (rng.randint(0, 256, (72, 128, 3)).astype(np.uint8),
            np.full((72, 128, 3), 200, np.uint8), np.zeros((72, 128, 3), np.uint8))


def test_reasoning_core_vl_backend_matches_jax(trio):
    """``ReasoningCore`` + ``Qwen3VLChatBackend``: the frame resized (the
    port's Pillow copy), patchified and spliced before the system turn; the
    prompt ids and the answers equal to JAX's at temperature 0 (f32 cache),
    and two frames answer differently."""
    from gvl_tpu.agent import ReasoningCoreConfig as JaxCoreConfig
    from gvl_tpu.agent.core import Qwen3VLChatBackend as JaxBackend
    from gvl_tpu.agent.core import ReasoningCore as JaxCore
    from gvl_tpu.fusion import ModalityType as JaxModality
    from gvl_tpu.fusion import TimelineIndexer as JaxTimeline
    from gvl_tpu_torch.agent import ReasoningCoreConfig, Qwen3VLChatBackend, ReasoningCore
    from gvl_tpu_torch.fusion import ModalityType, TimelineIndexer

    _, want_vl, got_vl = trio
    ids = dict(image_token_id=7, vision_start_id=5, vision_end_id=6, eos_token_id=-1,
               image_size=64)
    common = dict(max_new_tokens=5, temperature=0.0, embedding_model="hashing",
                  system_prompt="Answer from the timeline.")
    want_b = JaxBackend(want_vl, _HashIds(), **ids)
    got_b = Qwen3VLChatBackend(got_vl, _HashIds(), cache_dtype=torch.float32, **ids)
    want_core = JaxCore(JaxCoreConfig(**common), backend=want_b)
    got_core = ReasoningCore(ReasoningCoreConfig(**common), backend=got_b, device="cpu")
    jt, tt = JaxTimeline(), TimelineIndexer()
    jt.add_event(3.0, JaxModality.VISUAL, "boss appears")
    tt.add_event(3.0, ModalityType.VISUAL, "boss appears")
    answers = []
    for frame in _frames():
        messages = got_core.build_prompt("what is on screen?", "[00:03] boss appears",
                                         current_frame=frame)
        g_ids, g_patches, g_grid = got_b._prepare(messages)
        w_ids, w_patches, w_grid = want_b._prepare(messages)
        assert g_grid == w_grid == (1, 4, 4)
        assert np.array_equal(g_ids, w_ids) and np.array_equal(g_patches, w_patches)
        assert list(g_ids[0, :3]) == [5, 7, 7]
        kw = dict(current_frame=frame, track_conversation=False)
        want = want_core.reason("what is on screen?", timeline_indexer=jt, **kw)
        got = got_core.reason("what is on screen?", timeline_indexer=tt, **kw)
        assert got == want and len(got_b.last_tokens) == 5
        answers.append(got)
    assert len(set(answers)) == 3


def test_create_reasoning_core_vl_checkpoint_matches_jax(tmp_path):
    """``create_reasoning_core(vl_checkpoint_path=)`` on a saved tiny HF
    Qwen3-VL with the offline tokenizer: the port's backend (default bf16
    cache) answers as JAX's (f32 cache) on a frame."""
    from gvl_tpu.agent import ReasoningCoreConfig as JaxCoreConfig
    from gvl_tpu.agent.core import create_reasoning_core as jax_create_core
    from gvl_tpu_torch.agent import ReasoningCoreConfig, Qwen3VLChatBackend
    from gvl_tpu_torch.agent.core import create_reasoning_core

    from test_torch_hf_qwen3 import save_tiny_qwen3vl

    path = str(save_tiny_qwen3vl(tmp_path / "vl"))
    common = dict(max_new_tokens=4, temperature=0.0, embedding_model="hashing",
                  system_prompt="Answer from the timeline.")
    want_core = jax_create_core(JaxCoreConfig(**common), vl_checkpoint_path=path)
    got_core = create_reasoning_core(ReasoningCoreConfig(**common), vl_checkpoint_path=path,
                                     device="cpu")
    backend = got_core.backend
    assert isinstance(backend, Qwen3VLChatBackend)
    assert (backend.image_token_id, backend.vision_start_id, backend.vision_end_id) == (7, 5, 6)
    assert backend.cache_dtype == torch.bfloat16
    frame = _frames()[0]
    kw = dict(current_frame=frame, track_conversation=False)
    assert got_core.reason("what is on screen?", **kw) == want_core.reason(
        "what is on screen?", **kw)


@pytest.mark.parametrize("src,size", [((720, 1280), (448, 448)), ((720, 1280), (256, 256)),
                                      ((64, 64), (448, 448)), ((37, 91), (64, 23)),
                                      ((5, 3), (17, 40)), ((100, 100), (100, 50)),
                                      ((300, 200), (300, 200))])
def test_pil_bilinear_is_byte_equal_to_pillow(src, size):
    """Down- and up-scales, non-square on either side, one side kept, and
    the identity; random bytes and a gradient."""
    from PIL import Image

    rng = np.random.default_rng(sum(src) + sum(size))
    h, w = src
    gradient = (np.add.outer(np.arange(h), np.arange(w))[..., None]
                * np.array([1, 3, 7]) % 256).astype(np.uint8)
    for image in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), gradient):
        want = np.asarray(Image.fromarray(image).resize(size, Image.BILINEAR))
        got = pil_bilinear(image, size)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want)
