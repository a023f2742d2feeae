"""gvl_tpu_torch's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with nvcc (sm_90a) and skip elsewhere:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX, which the port does not need.)

Tolerances: f32 1e-4 (sums in another order); bf16 2e-2 absolute and
relative (the softmax weights and outputs round to bf16 at other places);
decode attention chip_smoke.py's ``decode_tol``, tied to the output's size.
"""

import pytest
import torch

from chip_smoke import decode_tol
from gvl_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Engine, init_params
from gvl_tpu_torch.ops.attention import attention_reference, flash_attention
from gvl_tpu_torch.ops import _build
from gvl_tpu_torch.ops.cache_update import (
    cache_append,
    cache_append_kv,
    cache_append_kv_reference,
    cache_append_reference,
    cache_append_stacked,
    cache_append_stacked_kv,
    cache_append_stacked_kv_reference,
    cache_append_stacked_reference,
)
from gvl_tpu_torch.ops.decode_attention import (
    chunk_attention,
    chunk_attention_reference,
    decode_attention,
    decode_attention_reference,
    decode_attention_stacked,
    decode_attention_stacked_reference,
)

pytestmark = pytest.mark.cuda

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _assert_decode_close(got, want):
    """chip_smoke.py's limit for decode attention: atol a share of each
    slot's largest |value|, rtol two bf16 steps (the outputs are weighted
    means far below BF16_TOL's atol)."""
    atol, rtol = decode_tol(want)
    err = (got.float() - want.float()).abs()
    assert (err <= atol + rtol * want.float().abs()).all(), err.max().item()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(dev, *shape, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv,seq,causal,kv_len", [
    (4, 4, 33, False, None), (8, 2, 100, True, None), (4, 1, 300, True, 257),
    (2, 2, 64, False, 1), (6, 3, 129, False, 100)])
def test_flash_attention_matches_plain(dev, dtype, d, hq, hkv, seq, causal, kv_len):
    q = _randn(dev, 2, hq, seq, d, dtype=dtype, seed=1)
    k = _randn(dev, 2, hkv, seq, d, dtype=dtype, seed=2)
    v = _randn(dev, 2, hkv, seq, d, dtype=dtype, seed=3)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    want = attention_reference(q, k, v, causal=causal, kv_len=kv_len)
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32_TOL if dtype == torch.float32 else BF16_TOL))
    assert flash_attention.launches == before + 1 and got.dtype == dtype


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv", [(64, 10, 5), (128, 32, 8), (64, 8, 1)])
def test_decode_attention_matches_plain(dev, qdtype, d, hq, hkv):
    s_max = 700
    lengths = torch.tensor([1, 255, 256, 257, 513, s_max], dtype=torch.int32, device=dev)
    q = _randn(dev, 6, hq, d, dtype=qdtype, seed=4)
    kc = _randn(dev, 6, hkv, s_max, d, dtype=torch.bfloat16, seed=5)
    vc = _randn(dev, 6, hkv, s_max, d, dtype=torch.bfloat16, seed=6)
    got = decode_attention(q, kc, vc, lengths)
    want = decode_attention_reference(q, kc, vc, lengths)
    _assert_decode_close(got, want)
    assert got.dtype == qdtype


def test_decode_attention_reads_only_the_live_prefix(dev):
    q = _randn(dev, 1, 4, 64, seed=7)
    kc = _randn(dev, 1, 2, 1024, 64, dtype=torch.bfloat16, seed=8)
    vc = _randn(dev, 1, 2, 1024, 64, dtype=torch.bfloat16, seed=9)
    lengths = torch.tensor([300], dtype=torch.int32, device=dev)
    first = decode_attention(q, kc, vc, lengths)
    kc[:, :, 300:] = float("nan")
    vc[:, :, 300:] = float("nan")
    assert torch.equal(decode_attention(q, kc, vc, lengths), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_append_in_place(dev, dtype):
    cache = _randn(dev, 3, 8, 64, 128, dtype=dtype, seed=10)
    new = _randn(dev, 3, 8, 128, dtype=dtype, seed=11)
    pos = torch.tensor([0, 63, 64], dtype=torch.int32, device=dev)   # 64: dropped
    want = cache_append_reference(cache, new, pos)
    ptr = cache.data_ptr()
    got = cache_append(cache, new, pos)
    assert got is cache and got.data_ptr() == ptr
    assert torch.equal(got, want)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv", [(64, 10, 5), (128, 32, 8)])
@pytest.mark.parametrize("layer", [0, 2])
def test_decode_attention_stacked_matches_plain(dev, qdtype, d, hq, hkv, layer):
    s_max = 700
    lengths = torch.tensor([1, 256, 513, s_max], dtype=torch.int32, device=dev)
    q = _randn(dev, 4, hq, d, dtype=qdtype, seed=12)
    k_all = _randn(dev, 3, 4, hkv, s_max, d, dtype=torch.bfloat16, seed=13)
    v_all = _randn(dev, 3, 4, hkv, s_max, d, dtype=torch.bfloat16, seed=14)
    before = decode_attention_stacked.launches
    got = decode_attention_stacked(q, k_all, v_all, lengths, layer)
    want = decode_attention_stacked_reference(q, k_all, v_all, lengths, layer)
    _assert_decode_close(got, want)
    assert decode_attention_stacked.launches == before + 1 and got.dtype == qdtype
    # the same numbers as the one-layer kernel on that layer
    assert torch.equal(got, decode_attention(q, k_all[layer].contiguous(),
                                             v_all[layer].contiguous(), lengths))


def test_decode_attention_stacked_reads_only_its_layer(dev):
    q = _randn(dev, 2, 8, 128, dtype=torch.bfloat16, seed=15)
    k_all = _randn(dev, 4, 2, 2, 256, 128, dtype=torch.bfloat16, seed=16)
    v_all = _randn(dev, 4, 2, 2, 256, 128, dtype=torch.bfloat16, seed=17)
    lengths = torch.tensor([100, 256], dtype=torch.int32, device=dev)
    first = decode_attention_stacked(q, k_all, v_all, lengths, 1)
    for other in (0, 2, 3):
        k_all[other] = float("nan")
        v_all[other] = float("nan")
    assert torch.equal(decode_attention_stacked(q, k_all, v_all, lengths, 1), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_append_stacked_in_place(dev, dtype):
    cache = _randn(dev, 3, 4, 8, 64, 128, dtype=dtype, seed=18)
    new = _randn(dev, 4, 8, 128, dtype=dtype, seed=19)
    pos = torch.tensor([0, 17, 63, 64], dtype=torch.int32, device=dev)  # 64: dropped
    want = cache_append_stacked_reference(cache, new, pos, 2)
    ptr = cache.data_ptr()
    before = cache_append_stacked.launches
    got = cache_append_stacked(cache, new, pos, 2)
    assert got is cache and got.data_ptr() == ptr
    assert torch.equal(got, want)
    assert cache_append_stacked.launches == before + 1


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv", [(64, 10, 5), (128, 32, 8), (64, 8, 1)])
@pytest.mark.parametrize("seq,starts,s_max", [
    (5, [0, 3, 200, 695], 700),        # a speculative verify, mixed offsets
    (37, [0, 1, 250, 663], 700),       # rows not a multiple of the tile
    (128, [1200, 0], 1536),            # a session delta at an offset
])
def test_chunk_attention_matches_plain(dev, qdtype, d, hq, hkv, seq, starts, s_max):
    batch = len(starts)
    q = _randn(dev, batch, hq, seq, d, dtype=qdtype, seed=20)
    kc = _randn(dev, batch, hkv, s_max, d, dtype=torch.bfloat16, seed=21)
    vc = _randn(dev, batch, hkv, s_max, d, dtype=torch.bfloat16, seed=22)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    before = chunk_attention.launches
    got = chunk_attention(q, kc, vc, start)
    want = chunk_attention_reference(q, kc, vc, start)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    assert chunk_attention.launches == before + 1 and got.dtype == qdtype


def test_chunk_attention_start_zero_is_causal_flash(dev):
    """A fresh admission: a 2048-token f32 chunk at offset 0 is causal
    attention over the chunk (S * G = 4096 rows, past the TPU's 512)."""
    q = _randn(dev, 1, 10, 2048, 64, seed=23)
    kc = _randn(dev, 1, 5, 4608, 64, dtype=torch.bfloat16, seed=24)
    vc = _randn(dev, 1, 5, 4608, 64, dtype=torch.bfloat16, seed=25)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    got = chunk_attention(q, kc, vc, start)
    want = attention_reference(q, kc[:, :, :2048].float(), vc[:, :, :2048].float(),
                               causal=True)
    torch.testing.assert_close(got, want, **BF16_TOL)


def test_chunk_attention_reads_only_live_keys(dev):
    q = _randn(dev, 2, 4, 9, 128, dtype=torch.bfloat16, seed=26)
    kc = _randn(dev, 2, 2, 512, 128, dtype=torch.bfloat16, seed=27)
    vc = _randn(dev, 2, 2, 512, 128, dtype=torch.bfloat16, seed=28)
    start = torch.tensor([10, 300], dtype=torch.int32, device=dev)
    first = chunk_attention(q, kc, vc, start)
    for b, s in enumerate((10, 300)):
        kc[b, :, s + 9:] = float("nan")
        vc[b, :, s + 9:] = float("nan")
    assert torch.equal(chunk_attention(q, kc, vc, start), first)


def _bits(t):
    """The tensor's bit patterns, so that NaN compares equal to itself."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _hard_rows(dev, shape, seed):
    """f32 rows with bf16 rounding ties (low 16 bits 0x8000), one ulp
    either side of them, NaN, +-inf and the largest f32 (rounds to inf)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    high = torch.randint(0x0080, 0x7F7F, shape, generator=gen, device=dev) << 16
    low = torch.tensor([0x8000, 0x7FFF, 0x8001, 0x0000], device=dev)[
        torch.randint(0, 4, shape, generator=gen, device=dev)]
    sign = torch.randint(0, 2, shape, generator=gen, device=dev) << 31
    bits = (high | low | sign).to(torch.int64)
    bits[..., :6] = torch.tensor([0x7FC00000, 0xFFC00001, 0x7F800000, 0xFF800000,
                                  0x7F7FFFFF, 0x3F808000], device=dev)
    return (bits - (bits >> 31 << 32)).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("cache_dtype,rows", [(torch.float32, "same"),
                                              (torch.bfloat16, "same"),
                                              (torch.bfloat16, "f32_into_bf16")])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layer", [None, 0, 2])
def test_cache_append_kv_bit_equal_in_place(dev, rows, cache_dtype, d, layer):
    """One launch writes K and V; bit-equal to the plain version (every
    other row untouched), in place; positions -1 and S_max write nothing;
    f32 rows cast in the kernel round as PyTorch's own cast."""
    s_max, lead = 48, () if layer is None else (3,)
    k_cache = _randn(dev, *lead, 5, 4, s_max, d, dtype=cache_dtype, seed=40)
    v_cache = _randn(dev, *lead, 5, 4, s_max, d, dtype=cache_dtype, seed=41)
    if rows == "same":
        k_new = _randn(dev, 5, 4, d, dtype=cache_dtype, seed=42)
        v_new = _randn(dev, 5, 4, d, dtype=cache_dtype, seed=43)
    else:
        k_new, v_new = _hard_rows(dev, (5, 4, d), 42), _hard_rows(dev, (5, 4, d), 43)
    pos = torch.tensor([0, -1, s_max - 1, s_max, 17], dtype=torch.int32, device=dev)
    ptrs = (k_cache.data_ptr(), v_cache.data_ptr())
    if layer is None:
        want = cache_append_kv_reference(k_cache, v_cache, k_new, v_new, pos)
        counter, before = cache_append, cache_append.launches
        got = cache_append_kv(k_cache, v_cache, k_new, v_new, pos)
    else:
        want = cache_append_stacked_kv_reference(k_cache, v_cache, k_new, v_new, pos, layer)
        counter, before = cache_append_stacked, cache_append_stacked.launches
        got = cache_append_stacked_kv(k_cache, v_cache, k_new, v_new, pos, layer)
    torch.cuda.synchronize()
    assert got[0] is k_cache and got[1] is v_cache
    assert (k_cache.data_ptr(), v_cache.data_ptr()) == ptrs
    assert counter.launches == before + 1
    for out, ref in zip(got, want):
        assert torch.equal(_bits(out), _bits(ref))
    if rows == "f32_into_bf16":
        assert torch.isnan(k_cache).any() and torch.isinf(v_cache).any()


def test_cache_append_launch_lands_on_the_current_stream(dev):
    """A launch inside torch.cuda.stream(s) waits behind s's work: the
    default stream does not see the write until s has run."""
    k_cache = torch.zeros(2, 4, 32, 64, dtype=torch.bfloat16, device=dev)
    v_cache = torch.zeros_like(k_cache)
    k_new = torch.ones(2, 4, 64, device=dev)
    pos = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    # every kernel below loaded once first: loading a kernel at its first
    # launch can wait for the whole device, and so for `side`
    torch.cuda._sleep(1000)
    cache_append_kv(k_cache, v_cache, k_new, k_new, pos)
    assert k_cache.sum().item() == 2 * 4 * 64
    k_cache.zero_()
    v_cache.zero_()
    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert _build.stream_handle(torch.cuda.current_device()) == side.cuda_stream
        torch.cuda._sleep(200_000_000)          # ~0.1 s of spinning on `side`
        cache_append_kv(k_cache, v_cache, k_new, k_new, pos)
    torch.cuda.current_stream(dev).synchronize()
    assert k_cache.sum().item() == 0 and not side.query()
    side.synchronize()
    assert k_cache.sum().item() == v_cache.sum().item() == 2 * 4 * 64


def test_stream_handle_is_the_current_stream(dev):
    index = torch.cuda.current_device()
    assert _build.stream_handle(index) == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert _build.stream_handle(index) == torch.cuda.current_stream(dev).cuda_stream
        assert _build.stream_handle(index) == side.cuda_stream
    graph = torch.cuda.CUDAGraph()
    handles, counter = [], torch.zeros(1, device=dev)
    with torch.cuda.graph(graph):
        handles.append((_build.stream_handle(index),
                        torch.cuda.current_stream(dev).cuda_stream))
        counter.add_(1)                  # a graph with one node
    assert handles[0][0] == handles[0][1]
    assert handles[0][0] != torch.cuda.default_stream(dev).cuda_stream


def test_cache_append_kv_captured_in_a_cuda_graph(dev):
    """A pair launch captured in a CUDA graph and replayed with new
    positions and rows writes the rows the positions name."""
    k_cache = _randn(dev, 2, 5, 64, 64, dtype=torch.bfloat16, seed=44)
    v_cache = _randn(dev, 2, 5, 64, 64, dtype=torch.bfloat16, seed=45)
    k_new, v_new = _randn(dev, 2, 5, 64, seed=46), _randn(dev, 2, 5, 64, seed=47)
    pos = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):                # warm-up outside the capture
        cache_append_kv(k_cache, v_cache, k_new, v_new, pos)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cache_append_kv(k_cache, v_cache, k_new, v_new, pos)
    for step, positions in enumerate(([7, 63], [40, 2])):
        pos.copy_(torch.tensor(positions, dtype=torch.int32, device=dev))
        k_new.copy_(_randn(dev, 2, 5, 64, seed=50 + step))
        v_new.copy_(_randn(dev, 2, 5, 64, seed=60 + step))
        want = cache_append_kv_reference(k_cache, v_cache, k_new, v_new, pos)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(k_cache, want[0]) and torch.equal(v_cache, want[1])


def test_qa_model_caches_bit_equal_through_the_pair_kernel(dev):
    """The QA model (outputs/qa_lm) after a prompt and 16 decode steps: its
    K/V caches through the pair kernel equal, bit for bit, those through
    the scatter route (use_cache_append_kernel=False)."""
    import dataclasses
    from pathlib import Path

    from gvl_tpu_torch.models.qwen3 import KVCache, load_model
    from gvl_tpu_torch.training.qa_lm_train import load_qa_lm

    cfg, state = load_qa_lm(Path(__file__).resolve().parents[1] / "outputs" / "qa_lm",
                            device=dev)
    prompt = torch.randint(3, 250, (1, 300), generator=torch.Generator().manual_seed(0))
    runs = []
    for use_kernel in (True, False):
        model = load_model(dataclasses.replace(cfg, use_cache_append_kernel=use_kernel),
                           state, dev)
        before = cache_append.launches
        with torch.inference_mode():
            cache = KVCache.zeros(cfg, 1, device=dev)
            logits, _ = model(prompt.to(dev), positions=torch.arange(300, device=dev),
                              cache=cache)
            tokens = []
            for _ in range(16):
                token = logits[:, -1].argmax(-1)
                tokens.append(int(token))
                n = cache.length
                logits, _ = model(token[:, None], positions=torch.tensor([n], device=dev),
                                  cache=cache)
        runs.append((cache, tokens, cache_append.launches - before))
    (kern, kern_tokens, launches), (plain, plain_tokens, none) = runs
    assert launches == 16 * cfg.num_layers and none == 0
    assert kern_tokens == plain_tokens
    for a, b in zip(kern.k + kern.v, plain.k + plain.v):
        assert torch.equal(_bits(a), _bits(b))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError, match="head_dim"):
        wide = _randn(dev, 1, 2, 8, 256)
        flash_attention(wide, wide, wide)
    q = _randn(dev, 1, 2, 8, 32)
    with pytest.raises(ValueError, match="bf16"):
        decode_attention(q[:, :, 0].contiguous(), q, q,
                         torch.ones(1, dtype=torch.int32, device=dev))
    cache = _randn(dev, 1, 1, 4, 128)
    with pytest.raises(ValueError, match="int32"):
        cache_append(cache, cache[:, :, 0].contiguous(),
                     torch.zeros(1, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3), q, q)
    kc = _randn(dev, 1, 2, 16, 64, dtype=torch.bfloat16)
    q4 = _randn(dev, 1, 4, 3, 64)
    with pytest.raises(ValueError, match="int32"):
        chunk_attention(q4, kc, kc, torch.zeros(1, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="bf16"):
        chunk_attention(q4, kc.float(), kc.float(),
                        torch.zeros(1, dtype=torch.int32, device=dev))
    k_all = kc[None].repeat(2, 1, 1, 1, 1)
    with pytest.raises(ValueError, match="layer"):
        decode_attention_stacked(q4[:, :, 0].contiguous(), k_all, k_all,
                                 torch.ones(1, dtype=torch.int32, device=dev), 2)
    with pytest.raises(ValueError, match="layer"):
        cache_append_stacked(k_all, kc[:, :, 0].contiguous(),
                             torch.zeros(1, dtype=torch.int32, device=dev), -1)
    both = _randn(dev, 2, 1, 2, 16, 64, dtype=torch.bfloat16)
    row = _randn(dev, 1, 2, 64)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="share memory"):
        cache_append_kv(both[0], both.view(-1)[64:64 + both[0].numel()].view_as(both[0]),
                        row, row, pos)
    with pytest.raises(ValueError, match="aligned"):
        flat = _randn(dev, 2 * 16 * 64 + 4, dtype=torch.bfloat16)   # 8 bytes off
        cache_append_kv(flat[4:].view(1, 2, 16, 64), both[1], row, row, pos)
    with pytest.raises(ValueError, match="f32 into a bf16"):
        cache_append_kv(both[0].float(), both[1].float(), row.bfloat16(),
                        row.bfloat16(), pos)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_tiny_engine_kernel_path_matches_plain_path(dev, head_dim):
    cfg = Qwen3Config.tiny(head_dim=head_dim, hidden_size=128)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    params = {k: v if k.endswith("norm.weight") else 5 * v for k, v in params.items()}
    prompt = list(range(3, 40))
    got = Qwen3Engine(cfg, params, eos_token_id=-1, device=dev).generate(
        prompt, max_new_tokens=12, temperature=0.0)
    want = Qwen3Engine(cfg.plain(), params, eos_token_id=-1, device=dev).generate(
        prompt, max_new_tokens=12, temperature=0.0)
    assert got == want


@pytest.mark.parametrize("head_dim", [64, 128])
def test_tiny_serving_kernel_path_matches_plain_path(dev, head_dim):
    """The batching engine (scan_layers: stacked append and decode at head_dim
    128), a session's second turn and prompt lookup, kernels against plain."""
    from gvl_tpu_torch.models.qwen3 import stack_layers
    from gvl_tpu_torch.models.session import Qwen3ChatSession
    from gvl_tpu_torch.models.speculative import PromptLookupEngine
    from gvl_tpu_torch.serving import ContinuousBatchingEngine

    cfg = Qwen3Config.tiny(head_dim=head_dim, hidden_size=128, max_cache_length=256)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    params = {k: v if k.endswith("norm.weight") else 5 * v for k, v in params.items()}
    prompts = [list(range(3, 40)), list(range(50, 60)), [7, 7, 7]]
    scan = Qwen3Config.tiny(head_dim=head_dim, hidden_size=128, max_cache_length=256,
                            scan_layers=True)
    stacked = stack_layers(params, cfg)
    counts = (decode_attention_stacked.launches, cache_append_stacked.launches,
              chunk_attention.launches)
    got = ContinuousBatchingEngine(scan, stacked, eos_token_id=-1, num_slots=2,
                                   device=dev).generate_many(prompts, 8)
    want = ContinuousBatchingEngine(scan.plain(), stacked, eos_token_id=-1,
                                    num_slots=2, device=dev).generate_many(prompts, 8)
    assert got == want
    assert chunk_attention.launches > counts[2]
    if head_dim == 128:
        assert decode_attention_stacked.launches > counts[0]
        assert cache_append_stacked.launches > counts[1]

    session = Qwen3ChatSession(cfg, params, eos_token_id=-1, device=dev)
    first = session.generate(prompts[0], max_new_tokens=6, temperature=0.0)
    transcript = prompts[0] + first + [90, 91, 92]
    second = session.generate(transcript, max_new_tokens=6, temperature=0.0)
    plain = Qwen3Engine(cfg.plain(), params, eos_token_id=-1, device=dev)
    assert second == plain.generate(transcript, max_new_tokens=6, temperature=0.0)
    lookup = PromptLookupEngine(cfg, params, gamma=4, eos_token_id=-1, device=dev)
    assert (lookup.generate(prompts[0], max_new_tokens=12, temperature=0.0)
            == plain.generate(prompts[0], max_new_tokens=12, temperature=0.0))


# ------------------------------------------------- fused W8A8 kernels (B7-B12)

def _int8(dev, *shape, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)


def _int8_close(got, want):
    """At most one step apart on at most 0.1 % of the elements (exp2,
    rsqrt and f32 sums in another order)."""
    diff = (got.int() - want.int()).abs()
    assert got.dtype == want.dtype == torch.int8
    assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("epilogue", ["none", "residual", "gelu_quant", "quant"])
@pytest.mark.parametrize("m,k,n,bias", [(64, 128, 256, True), (96, 128, 384, False),
                                        (200, 1152, 384, True), (1536, 2048, 1152, True)])
def test_w8a8_matmul_matches_plain(dev, epilogue, m, k, n, bias):
    from gvl_tpu_torch.ops.quant_matmul import w8a8_matmul, w8a8_matmul_reference

    x, w = _int8(dev, m, k, seed=1), _int8(dev, n, k, seed=2)
    # acc has a spread of about 5376 sqrt(K): y lands around +-60 for quant,
    # +-3 for the GELU requantize at 37.5
    unit = 1.0 / (5376 * k ** 0.5)
    scale = (_randn(dev, n, seed=3).abs() + 0.5) * unit * (60 if epilogue == "quant" else 3)
    b = _randn(dev, n, seed=4) * 0.1 if bias else None
    res = _randn(dev, m, n, seed=5, dtype=torch.bfloat16)
    kw = dict(epilogue=epilogue, out_scale_inv=37.5 if epilogue == "gelu_quant" else None,
              residual=res if epilogue == "residual" else None)
    before = w8a8_matmul.launches
    got = w8a8_matmul(x, w, scale, b, **kw)
    want = w8a8_matmul_reference(x, w, scale, b, **kw)
    torch.cuda.synchronize()
    assert w8a8_matmul.launches == before + 1
    if epilogue in ("gelu_quant", "quant"):
        _int8_close(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


def test_w8a8_matmul_integer_sum_is_exact(dev):
    """scale 1, no bias, f32 out: the output is the int32 sum itself."""
    from gvl_tpu_torch.ops.quant_matmul import int_matmul, w8a8_matmul

    x, w = _int8(dev, 128, 4352, seed=6), _int8(dev, 256, 4352, seed=7)
    got = w8a8_matmul(x, w, torch.ones(256, device=dev), out_dtype=torch.float32)
    assert torch.equal(got, int_matmul(x, w.T).float())


@pytest.mark.parametrize("m,k,n,block_n", [
    (200, 1152, 384, None),     # ragged M; N 384 takes the 128 tile
    (200, 1152, 1152, 256),     # ragged N: 4.5 tiles of 256
    (200, 1152, 1152, 144),     # the o-projection's width
    (200, 1152, 1152, 128),
    (64, 4352, 256, 256),       # 34 K stages: the 4-stage ring wraps 8 times
    (96, 16, 384, 128),         # the smallest K: one 16-byte column of a stage
    (130, 48, 144, 144),        # K short of a stage, M one row past a tile
    (1, 16, 16, 256),           # one row, one column group
    (2000, 1152, 6144, None),   # 384 tiles on 132 SMs: each block walks several
])
def test_w8a8_matmul_exact_sum_at_tile_edges(dev, monkeypatch, m, k, n, block_n):
    """scale 1, no bias, f32 out: the output is the int32 sum itself, at
    every edge of the tiling and with every tile width (a block_n forces
    the wrapper's choice)."""
    from gvl_tpu_torch.ops import quant_matmul as qm

    if block_n is not None:
        monkeypatch.setattr(qm, "w8a8_block_n", lambda _n: block_n)
    x, w = _int8(dev, m, k, seed=m + k), _int8(dev, n, k, seed=n + k)
    got = qm.w8a8_matmul(x, w, torch.ones(n, device=dev), out_dtype=torch.float32)
    assert torch.equal(got, qm.int_matmul(x, w.T).float())


@pytest.mark.parametrize("epilogue", ["none", "residual", "gelu_quant", "quant"])
@pytest.mark.parametrize("k,n", [(1152, 6144), (2048, 1152), (1152, 4352), (4352, 1152),
                                 (1152, 3456), (1152, 1152)])
def test_w8a8_matmul_served_products_every_epilogue(dev, epilogue, k, n):
    """The tower's four products (qkv, o-projection, fc1, fc2) and the
    packed-head qkv and o-projection, 200 rows (two tiles, one ragged),
    every epilogue.  The f32 steps are the plain version's, each rounded
    once, so none, residual and quant are bit-equal; gelu_quant's exp2f
    may differ from torch.exp2 in the last bit (int8 within one step)."""
    from gvl_tpu_torch.ops.quant_matmul import w8a8_matmul, w8a8_matmul_reference

    m = 200
    x, w = _int8(dev, m, k, seed=k), _int8(dev, n, k, seed=n)
    unit = 1.0 / (5376 * k ** 0.5)
    scale = (_randn(dev, n, seed=3).abs() + 0.5) * unit * (60 if epilogue == "quant" else 3)
    b = _randn(dev, n, seed=4) * 0.1
    res = _randn(dev, m, n, seed=5, dtype=torch.bfloat16)
    kw = dict(epilogue=epilogue, out_scale_inv=37.5 if epilogue == "gelu_quant" else None,
              residual=res if epilogue == "residual" else None)
    got = w8a8_matmul(x, w, scale, b, **kw)
    want = w8a8_matmul_reference(x, w, scale, b, **kw)
    if epilogue == "gelu_quant":
        _int8_close(got, want)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(64, 256), (5888, 1152), (100, 4352)])
def test_ln_quant_and_quant_static_match_plain(dev, dtype, rows, d):
    from gvl_tpu_torch.ops.quant_matmul import (
        ln_quant,
        ln_quant_reference,
        quant_static,
        quant_static_reference,
    )

    x = _randn(dev, rows, d, seed=8, dtype=dtype) * 2.0
    g = _randn(dev, d, seed=9).abs() + 0.5
    b = _randn(dev, d, seed=10) * 0.1
    _int8_close(ln_quant(x, g, b, 40.0), ln_quant_reference(x, g, b, 40.0))
    _int8_close(quant_static(x, 20.0), quant_static_reference(x, 20.0))


def test_w8a8_matmul_gelu_quant_at_the_division_edges(dev):
    """GELU's division y / (1 + exp2(..)) runs without a branch: scaled by
    2^-64 where the denominator passes 2^64 (y below about -7), selects for
    y exactly 0 and for a denominator that overflows to inf (y below about
    -12); tiny and large y, all mixed in one warp's columns, against the
    plain version."""
    from gvl_tpu_torch.ops.quant_matmul import w8a8_matmul, w8a8_matmul_reference

    m, k, n = 256, 1152, 512
    x, w = _int8(dev, m, k, seed=11), _int8(dev, n, k, seed=12)
    x[:8] = 0                                           # rows whose y is the bias alone
    unit = 1.0 / (5376 * k ** 0.5)
    scale = (_randn(dev, n, seed=13).abs() + 0.5) * unit * 20     # y spreads about +-40
    b = torch.zeros(n, device=dev)
    b[1::4] = -30.0
    b[2::4] = 1e-35
    b[3::4] = -1e-30
    got = w8a8_matmul(x, w, scale, b, epilogue="gelu_quant", out_scale_inv=3.0)
    want = w8a8_matmul_reference(x, w, scale, b, epilogue="gelu_quant", out_scale_inv=3.0)
    _int8_close(got, want)


@pytest.mark.parametrize("dtype,rows,d", [
    (torch.bfloat16, 5889, 1152),   # not a multiple of 8 rows a block; warps walk 2 rows
    (torch.bfloat16, 40000, 256),   # each warp walks ~5 rows through its two buffers
    (torch.bfloat16, 13, 4352),
    (torch.float32, 7, 4352),       # 5 warps a block (shared memory)
    (torch.float32, 3, 8),
])
def test_ln_quant_row_and_width_edges(dev, dtype, rows, d):
    from gvl_tpu_torch.ops.quant_matmul import ln_quant, ln_quant_reference

    x = _randn(dev, rows, d, seed=rows, dtype=dtype) * 2.0
    g = _randn(dev, d, seed=9).abs() + 0.5
    b = _randn(dev, d, seed=10) * 0.1
    _int8_close(ln_quant(x, g, b, 40.0), ln_quant_reference(x, g, b, 40.0))


def test_ln_quant_and_quant_static_reject_misaligned_rows(dev):
    """A contiguous view at an odd offset would fault the kernels' 16-byte
    loads: the wrappers refuse it."""
    from gvl_tpu_torch.ops.quant_matmul import ln_quant, quant_static

    flat = _randn(dev, 4 * 1152 + 1, seed=8, dtype=torch.bfloat16)
    x = flat[1:].view(4, 1152)
    assert x.is_contiguous() and x.data_ptr() % 16
    g, b = torch.ones(1152, device=dev), torch.zeros(1152, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        ln_quant(x, g, b, 40.0)
    with pytest.raises(ValueError, match="aligned"):
        quant_static(x, 20.0)


def _fused_qkv(dev, b, sp, kv_len, h, dh, dtype, seed, pad_max=False):
    """A head-padded projection as served (columns 72 .. 127 of each head
    zero at dh 128); with ``pad_max`` the rows at or past kv_len are scaled
    by 4, so that they hold the largest |x| of every K and V slab."""
    qkv = _randn(dev, b * sp, 3 * h * dh, seed=seed, dtype=dtype)
    if dh == 128:
        qkv.view(b * sp, 3 * h, 128)[..., 72:] = 0
    if pad_max:
        qkv.view(b, sp, -1)[:, kv_len:] *= 4
    return qkv


@pytest.mark.parametrize("int8_scores", [False, True])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b,sp,kv_len,h,block_q,dh,dtype,pad_max", [
    (2, 64, 57, 4, 1024, 128, torch.bfloat16, False),
    (1, 96, 81, 2, 32, 128, torch.bfloat16, False),
    (2, 736, 729, 16, 1024, 128, torch.bfloat16, False),
    (1, 1024, 1000, 4, 1024, 128, torch.bfloat16, False),   # the largest Sp of int8_scores
    (2, 96, 81, 4, 1024, 128, torch.float32, False),
    (2, 736, 729, 4, 1024, 72, torch.bfloat16, False),      # dh 72, unpadded
    (2, 736, 729, 4, 1024, 128, torch.bfloat16, True)])     # an amax that skips rows fails
def test_attention_fused_qkv_matches_plain(dev, int8_scores, quant, b, sp, kv_len, h,
                                           block_q, dh, dtype, pad_max):
    from gvl_tpu_torch.ops.quant_matmul import (
        attention_fused_qkv,
        attention_fused_qkv_reference,
    )

    qkv = _fused_qkv(dev, b, sp, kv_len, h, dh, dtype, seed=11, pad_max=pad_max)
    kw = dict(batch=b, seq_pad=sp, kv_len=kv_len, num_heads=h, dh_pad=dh,
              sm_scale=1.0 / 72 ** 0.5, int8_scores=int8_scores, block_q=block_q,
              out_scale_inv=40.0 if quant else None)
    before = attention_fused_qkv.launches
    got = attention_fused_qkv(qkv, **kw)
    want = attention_fused_qkv_reference(qkv, **kw)
    torch.cuda.synchronize()
    assert attention_fused_qkv.launches == before + 1
    if quant:
        _int8_close(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   **(F32_TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sp,kv_len,h,dh,quant", [
    (2, 64, 57, 8, 48, False), (1, 32, 32, 4, 96, True), (2, 96, 81, 16, 72, True),
    (1, 64, 60, 2, 128, False), (2, 736, 729, 16, 72, True)])
def test_packed_attention_matches_plain(dev, dtype, b, sp, kv_len, h, dh, quant):
    from gvl_tpu_torch.ops.quant_matmul import (
        attention_packed_multihead,
        attention_packed_multihead_reference,
        attention_qkv_packed,
        attention_qkv_packed_reference,
    )

    qkv = _randn(dev, b * sp, 3 * h * dh, seed=12, dtype=dtype)
    kw = dict(batch=b, seq_pad=sp, kv_len=kv_len, num_heads=h, head_dim=dh,
              sm_scale=1.0 / dh ** 0.5)
    inv = 40.0 if quant else None
    got = attention_packed_multihead(qkv, out_scale_inv=inv, **kw)
    want = attention_packed_multihead_reference(qkv, out_scale_inv=inv, **kw)
    got12 = attention_qkv_packed(qkv, **kw)
    want12 = attention_qkv_packed_reference(qkv, **kw)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    if quant:
        _int8_close(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(got12.float(), want12.float(), **tol)


def test_flash_attention_pads_head_dim_72(dev):
    q = _randn(dev, 2, 16, 100, 72, seed=13, dtype=torch.bfloat16)
    k = _randn(dev, 2, 16, 100, 72, seed=14, dtype=torch.bfloat16)
    got = flash_attention(q, k, k, kv_len=90)
    assert got.shape == q.shape
    torch.testing.assert_close(got.float(), attention_reference(q, k, k, kv_len=90).float(),
                               **BF16_TOL)


def test_tiny_fused_tower_kernel_path_matches_plain_path(dev):
    """The fused tower (padded and packed heads) on the card against the
    same fused tree on the CPU's plain versions: pooled cosine."""
    from gvl_tpu_torch.models.siglip import SigLIPVisionConfig, init_tower_params
    from gvl_tpu_torch.models.siglip_fused import prepare_fused_siglip, siglip_fused_apply

    cfg = SigLIPVisionConfig(hidden_size=128, intermediate_size=192, num_layers=2,
                             num_heads=4, image_size=56)
    state = init_tower_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    pix = _randn(dev, 3, 56, 56, 3, seed=15) * 0.5
    for packed in (False, True):
        fused = prepare_fused_siglip(state, cfg, pix, packed_attention=packed)
        got = siglip_fused_apply(fused, pix, cfg)["pooled"].float()
        want = siglip_fused_apply(fused, pix, cfg, kernels=False)["pooled"].float()
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
        assert cos.min().item() >= 0.9995, cos


def test_tiny_fused_tower_int8_attention_kernel_path_matches_plain_path(dev):
    """``int8_attention``: B9 in its int8_scores mode, once per layer, on the
    padded layout; the packed layout ignores the flag (B10, no B9)."""
    from gvl_tpu_torch.models.siglip import SigLIPVisionConfig, init_tower_params
    from gvl_tpu_torch.models.siglip_fused import prepare_fused_siglip, siglip_fused_apply
    from gvl_tpu_torch.ops.quant_matmul import attention_fused_qkv

    cfg = SigLIPVisionConfig(hidden_size=128, intermediate_size=192, num_layers=2,
                             num_heads=4, image_size=56)
    state = init_tower_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    pix = _randn(dev, 3, 56, 56, 3, seed=15) * 0.5
    for packed in (False, True):
        fused = prepare_fused_siglip(state, cfg, pix, packed_attention=packed)
        before = attention_fused_qkv.launches
        got = siglip_fused_apply(fused, pix, cfg, int8_attention=True)["pooled"].float()
        torch.cuda.synchronize()
        assert attention_fused_qkv.launches - before == (0 if packed else cfg.num_layers)
        want = siglip_fused_apply(fused, pix, cfg, int8_attention=True,
                                  kernels=False)["pooled"].float()
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
        assert cos.min().item() >= 0.9995, cos
        if packed:
            assert torch.equal(got, siglip_fused_apply(fused, pix, cfg)["pooled"].float())


def test_generic_decoder_stack_kernel_path_matches_plain_path(dev):
    """``nn.TransformerStack`` of the decoder family (RMSNorm, SwiGLU, causal
    GQA, rope, qk-norm, no biases) in bf16 under autograd: B1 once per layer
    forward and once per layer for the blockwise backward's delta (1100
    positions), none on the plain path; output and gradients alike."""
    from gvl_tpu_torch.nn.layers import TransformerStack, plain_attention

    torch.manual_seed(0)
    model = TransformerStack(2, 256, 4, 512, num_kv_heads=2, head_dim=64, norm="rmsnorm",
                             mlp="swiglu", causal=True, rope=True, rope_base=1e6,
                             qk_norm=True, use_bias=False).to(dev, torch.bfloat16)
    x = _randn(dev, 1, 1100, 256, dtype=torch.bfloat16, seed=5)
    g = _randn(dev, 1, 1100, 256, seed=6)
    results = []
    for plain in (False, True):
        model.zero_grad()
        leaf = x.clone().requires_grad_()
        before = flash_attention.launches
        if plain:
            with plain_attention():
                out = model(leaf)
                (out.float() * g).sum().backward()
        else:
            out = model(leaf)
            (out.float() * g).sum().backward()
        torch.cuda.synchronize()
        grads = [leaf.grad] + [p.grad.clone() for p in model.parameters()]
        results.append((out, grads, flash_attention.launches - before))
    (out_k, grads_k, n_k), (out_p, grads_p, n_p) = results
    assert (n_k, n_p) == (4, 0)
    torch.testing.assert_close(out_k, out_p, **BF16_TOL)
    for a, b in zip(grads_k, grads_p):
        rel = ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-12)).item()
        assert rel <= 2e-2, rel


# --------------------------------------------------------------------------
# edges of the tensor-core tiling: 64-row query tiles, 64-key K/V tiles
# --------------------------------------------------------------------------

def _encoder_pairs(qkv, kw, dh):
    """(kernel, plain, int8?) outputs of every encoder-attention entry point
    that takes this head width: B10 requantized, B12, and B9 at dh 128."""
    from gvl_tpu_torch.ops import quant_matmul as qm

    runs = [(qm.attention_packed_multihead(qkv, head_dim=dh, out_scale_inv=40.0, **kw),
             qm.attention_packed_multihead_reference(qkv, head_dim=dh, out_scale_inv=40.0,
                                                     **kw), True),
            (qm.attention_qkv_packed(qkv, head_dim=dh, **kw),
             qm.attention_qkv_packed_reference(qkv, head_dim=dh, **kw), False)]
    if dh == 128:
        for inv in (40.0, None):
            runs.append((qm.attention_fused_qkv(qkv, dh_pad=128, out_scale_inv=inv, **kw),
                         qm.attention_fused_qkv_reference(qkv, dh_pad=128,
                                                          out_scale_inv=inv, **kw),
                         inv is not None))
    torch.cuda.synchronize()
    return runs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [72, 128])
@pytest.mark.parametrize("sp,kv_len", [(96, 63), (96, 64), (96, 65),
                                       (736, 639), (736, 640), (736, 641)])
def test_encoder_attention_key_tile_edges(dev, dtype, dh, sp, kv_len):
    """kv_len one below, at and one above a 64-key tile boundary, Sp not a
    multiple of the 64-row query tile; B9's pad columns are random data."""
    b, h = 2, 4
    qkv = _randn(dev, b * sp, 3 * h * dh, seed=30, dtype=dtype)
    kw = dict(batch=b, seq_pad=sp, kv_len=kv_len, num_heads=h, sm_scale=1.0 / 72 ** 0.5)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for got, want, is_int8 in _encoder_pairs(qkv, kw, dh):
        if is_int8:
            _int8_close(got, want)
        else:
            torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b,sp,kv_len,h", [(1, 96, 65, 2), (2, 736, 729, 4),
                                           (1, 1024, 1000, 4)])
def test_attention_fused_qkv_int8_scores_block_q_32(dev, quant, b, sp, kv_len, h):
    """int8_scores with q quantized per 32-row block: several q blocks, and
    several scales in every 64-row half of a 128-row query tile (32 blocks
    at Sp 1024)."""
    from gvl_tpu_torch.ops.quant_matmul import (
        attention_fused_qkv,
        attention_fused_qkv_reference,
    )

    qkv = _fused_qkv(dev, b, sp, kv_len, h, 128, torch.bfloat16, seed=31)
    kw = dict(batch=b, seq_pad=sp, kv_len=kv_len, num_heads=h, dh_pad=128,
              sm_scale=1.0 / 72 ** 0.5, int8_scores=True, block_q=32,
              out_scale_inv=40.0 if quant else None)
    got = attention_fused_qkv(qkv, **kw)
    want = attention_fused_qkv_reference(qkv, **kw)
    torch.cuda.synchronize()
    if quant:
        _int8_close(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("dh", [72, 128])
def test_encoder_attention_ignores_keys_past_kv_len(dev, dh):
    """NaN in the k and v columns of every row at or past kv_len (the padded
    key rows) changes no output bit: those rows are zero-filled on load."""
    b, sp, kv_len, h = 2, 736, 729, 4
    qkv = _randn(dev, b * sp, 3 * h * dh, seed=32, dtype=torch.bfloat16)
    kw = dict(batch=b, seq_pad=sp, kv_len=kv_len, num_heads=h, sm_scale=1.0 / 72 ** 0.5)
    clean = [got.clone() for got, _, _ in _encoder_pairs(qkv, kw, dh)]
    qkv.view(b, sp, 3, h * dh)[:, kv_len:, 1:] = float("nan")
    for before, (after, _, _) in zip(clean, _encoder_pairs(qkv, kw, dh)):
        assert torch.equal(before, after)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (10, 5), (16, 4)])      # G 1, 2, 4
@pytest.mark.parametrize("seq,starts,s_max", [
    (7, [0, 70], 256),             # 7 G rows: under one 16-row warp tile
    (37, [3, 100], 512),           # rows not a multiple of 16 or 64
    (64, [4544], 4608),            # the slot's live end is the cache end
    (200, [0, 1000], 1536),        # several row tiles, a diagonal per tile
])
def test_chunk_attention_tile_edges(dev, qdtype, d, hq, hkv, seq, starts, s_max):
    batch = len(starts)
    q = _randn(dev, batch, hq, seq, d, dtype=qdtype, seed=33)
    kc = _randn(dev, batch, hkv, s_max, d, dtype=torch.bfloat16, seed=34)
    vc = _randn(dev, batch, hkv, s_max, d, dtype=torch.bfloat16, seed=35)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    first = chunk_attention(q, kc, vc, start)
    torch.testing.assert_close(first.float(),
                               chunk_attention_reference(q, kc, vc, start).float(),
                               **BF16_TOL)
    for b, s in enumerate(starts):            # nothing past the live end is read
        kc[b, :, s + seq:] = float("nan")
        vc[b, :, s + seq:] = float("nan")
    assert torch.equal(chunk_attention(q, kc, vc, start), first)


def test_chunk_attention_f32_query_keeps_f32_scores(dev):
    """The f32 query is split into bf16 hi + lo against the bf16 keys, so the
    scores keep f32-level error.  Held against an f64 evaluation that rounds
    p to bf16 as the kernel does: with one 64-key tile per row (start 0, 64
    positions) the kernel's running maximum is the row's maximum, and the two
    differ only where a score error moves p across a bf16 rounding step.
    - mean |error| at most 1e-5 (a CPU emulation of the split gives ~7e-7),
      and at most 1/20 of the same kernel's on the query rounded to bf16
      (lo = 0: ~5e-4 in the emulation);
    - max |error| at most 2**-7 max|v|: a weight p_j that rounds one bf16
      step (at most 2**-7 p_j) the other way moves an output by at most
      2**-7 (p_j / l) |v_j|."""
    import math

    q = _randn(dev, 1, 8, 64, 64, seed=36)
    kc = _randn(dev, 1, 4, 128, 64, dtype=torch.bfloat16, seed=37)
    vc = _randn(dev, 1, 4, 128, 64, dtype=torch.bfloat16, seed=38)
    start = torch.zeros(1, dtype=torch.int32, device=dev)

    k64 = kc[:, :, :64].double().repeat_interleave(2, dim=1)
    v64 = vc[:, :, :64].double().repeat_interleave(2, dim=1)
    s = torch.matmul(q.double(), k64.transpose(-1, -2)) / math.sqrt(64)
    live = torch.ones(64, 64, dtype=torch.bool, device=dev).tril()
    s = s.masked_fill(~live, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = torch.matmul(p.to(torch.bfloat16).double(), v64) / p.sum(-1, keepdim=True)
    err = (chunk_attention(q, kc, vc, start).double() - want).abs()
    unsplit = chunk_attention(q.to(torch.bfloat16).float(), kc, vc, start).double()
    err_unsplit = (unsplit - want).abs().mean().item()
    assert err.mean().item() <= min(1e-5, err_unsplit / 20), (err.mean().item(),
                                                              err_unsplit)
    assert err.max().item() <= 2.0 ** -7 * v64.abs().max().item(), err.max().item()


# ---------------------------------------------- flash attention on tensor cores

def _flash_case(dev, dtype, d, hq, hkv, sq, sk, seed, batch=2):
    q = _randn(dev, batch, hq, sq, d, dtype=dtype, seed=seed)
    k = _randn(dev, batch, hkv, sk, d, dtype=dtype, seed=seed + 1)
    v = _randn(dev, batch, hkv, sk, d, dtype=dtype, seed=seed + 2)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("hq,hkv,sq,sk,causal,kv_len", [
    *[(4, 2, s, s, c, None) for s in (1, 63, 64, 65, 127, 128, 129) for c in (False, True)],
    (10, 5, 4096, 4096, True, None),                      # the QA prefill bucket
    *[(4, 4, 100, 100, c, kv) for kv in (1, 63, 64, 65) for c in (False, True)],
    (4, 2, 70, 200, True, None), (8, 2, 200, 70, True, None),   # non-square causal
    (8, 1, 129, 129, True, 100),                          # G 8, kv_len inside a tile
    (12, 4, 65, 65, True, None),                          # G 3
])
def test_flash_attention_tile_edges(dev, dtype, d, hq, hkv, sq, sk, causal, kv_len):
    """Sequences at and around the 64-key tiles and the block's 128 (f32 D
    128: 64) rows, at each head size the kernel is built for, kv_len
    around a tile, non-square causal masks (top-left aligned, as
    attention_reference), against the plain version."""
    q, k, v = _flash_case(dev, dtype, d, hq, hkv, sq, sk, seed=70, batch=1 if sq > 1000 else 2)
    got = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    want = attention_reference(q, k, v, causal=causal, kv_len=kv_len)
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32_TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kv_len_0_gives_0(dev, dtype, causal):
    """No live key: the kernel gives 0 (ROADMAP C, "Rows with no live
    key"; the plain version, as JAX's reference, the mean of v)."""
    q, k, v = _flash_case(dev, dtype, 64, 4, 2, 65, 65, seed=73)
    got = flash_attention(q, k, v, causal=causal, kv_len=0)
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_map_head_shape(dev, dtype):
    """The SigLIP MAP head: one query row over 729 keys, head_dim 72
    (padded to 80 by the wrapper), 16 heads."""
    q = _randn(dev, 8, 16, 1, 72, dtype=dtype, seed=76)
    k = _randn(dev, 8, 16, 729, 72, dtype=dtype, seed=77)
    v = _randn(dev, 8, 16, 729, 72, dtype=dtype, seed=78)
    got = flash_attention(q, k, v)
    assert got.shape == q.shape
    torch.testing.assert_close(got.float(), attention_reference(q, k, v).float(),
                               **(F32_TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_ignores_keys_past_kv_len(dev, dtype, d, causal):
    q, k, v = _flash_case(dev, dtype, d, 4, 2, 150, 150, seed=79)
    first = flash_attention(q, k, v, causal=causal, kv_len=97)
    k[:, :, 97:] = float("nan")
    v[:, :, 97:] = float("nan")
    assert torch.equal(flash_attention(q, k, v, causal=causal, kv_len=97), first)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_f32_against_f64(dev, causal):
    """f32 q, k, v are split into bf16 hi + lo and q k^T and P V each take
    hi.hi + hi.lo + lo.hi, so the kernel keeps f32-level error.  Held
    against an f64 evaluation of the same math (for f32 the softmax weights
    are not rounded, so the f64 softmax is the exact target), at 200 keys
    (four 64-key tiles: the online rescale is exercised):
    - the split leaves |x - hi - lo| <= 2**-18 |x| and drops lo.lo <= 2**-18
      |x||y|, so each product is within ~2**-17 relative and a 64-term score
      within ~1e-5 absolute before the scale; mean |error| at most 1e-5, and
      at most 1/20 of the same kernel's on inputs rounded to bf16 (lo = 0),
      which carries bf16's 2**-9 relative error (~5e-4);
    - max |error| at most 1e-4, the f32 tolerance of the other tests: a score
      error e moves a weight by a factor exp(e) ~ 1 + e, so the output by at
      most ~e max|v| ~ 5e-5."""
    q, k, v = _flash_case(dev, torch.float32, 64, 4, 2, 200, 200, seed=82)

    def f64(q, k, v):
        kk, vv = (t.double().repeat_interleave(2, dim=1) for t in (k, v))
        s = torch.matmul(q.double(), kk.transpose(-1, -2)) / 8.0
        if causal:
            s = s.masked_fill(torch.ones(200, 200, dtype=torch.bool, device=dev).triu(1),
                              float("-inf"))
        return torch.matmul(torch.softmax(s, dim=-1), vv)

    want = f64(q, k, v)
    err = (flash_attention(q, k, v, causal=causal).double() - want).abs()
    rounded = [t.to(torch.bfloat16).float() for t in (q, k, v)]
    err_unsplit = (flash_attention(*rounded, causal=causal).double() - want).abs().mean().item()
    assert err.mean().item() <= min(1e-5, err_unsplit / 20), (err.mean().item(), err_unsplit)
    assert err.max().item() <= 1e-4, err.max().item()


# ------------------------------------ decode attention: one launch per call

def _share_edge_lengths(s_max, split):
    """0, 1, 63, 64, 65, S_max, and lengths whose block shares under a split
    of ``split`` blocks (ceil(len / split) keys a block) are 1 or 2 keys, end
    on an edge of the per-warp tiles (16 keys at D 64, 8 at D 128) or of a
    round of the block's four warps, or go one key past one, with the last
    blocks of the cluster full, short or empty."""
    lengths = {0, 1, 63, 64, 65, s_max}
    for share in (1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 128, 129):
        for n in (split * share - 1, split * share, split * share + 1,
                  (split - 3) * share + 1):
            if 0 < n <= s_max:
                lengths.add(n)
    return sorted(lengths)


def _library_split() -> int:
    """Blocks per (slot, KV head) of the built kernel: one thread-block
    cluster, at most the portable 8."""
    split = _build.entry("gvl_decode_attention_split")()
    assert 1 <= split <= 8, split
    return split


def test_share_edge_lengths_cover_the_split():
    for split in (2, 4, 8):
        lengths = _share_edge_lengths(1100, split)
        shares = [-(-n // split) for n in lengths]
        assert any(n - (split - 1) * sh <= 0 < n for n, sh in zip(lengths, shares))  # empty last
        for edge in (8, 16, 64):
            assert any(sh == edge and n == split * sh for n, sh in zip(lengths, shares))
            assert any(sh == edge + 1 for sh in shares)                  # one key past
        assert 0 in lengths and 1100 in lengths


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
def test_decode_attention_split_edges(dev, qdtype, d, group):
    """One slot per length of _share_edge_lengths: every block-share
    boundary of the cluster's split, for G 1, 2, 3 (rounded up to 4 in the
    kernel), 4 and 8; a length-0 slot gives 0; NaN past each slot's length
    leaves the output bit for bit unchanged."""
    s_max, hkv = 1100, 2
    lengths = torch.tensor(_share_edge_lengths(s_max, _library_split()), dtype=torch.int32,
                           device=dev)
    batch = lengths.numel()
    q = _randn(dev, batch, group * hkv, d, dtype=qdtype, seed=85)
    kc = _randn(dev, batch, hkv, s_max, d, dtype=torch.bfloat16, seed=86)
    vc = _randn(dev, batch, hkv, s_max, d, dtype=torch.bfloat16, seed=87)
    got = decode_attention(q, kc, vc, lengths)
    live = lengths > 0
    _assert_decode_close(got[live], decode_attention_reference(q, kc, vc, lengths)[live])
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    for b, n in enumerate(lengths.tolist()):
        kc[b, :, n:] = float("nan")
        vc[b, :, n:] = float("nan")
    assert torch.equal(decode_attention(q, kc, vc, lengths), got)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_decode_attention_stacked_split_edges(dev, group):
    """The stacked entry point on the same body: layer 1 of 3 equals the
    one-layer kernel on that layer bit for bit, at every share boundary,
    and ignores NaN past the lengths and in the other layers."""
    s_max, hkv = 1100, 2
    lengths = torch.tensor(_share_edge_lengths(s_max, _library_split()), dtype=torch.int32,
                           device=dev)
    batch = lengths.numel()
    q = _randn(dev, batch, group * hkv, 128, dtype=torch.bfloat16, seed=88)
    k_all = _randn(dev, 3, batch, hkv, s_max, 128, dtype=torch.bfloat16, seed=89)
    v_all = _randn(dev, 3, batch, hkv, s_max, 128, dtype=torch.bfloat16, seed=90)
    got = decode_attention_stacked(q, k_all, v_all, lengths, 1)
    assert torch.equal(got, decode_attention(q, k_all[1].contiguous(),
                                             v_all[1].contiguous(), lengths))
    live = lengths > 0
    _assert_decode_close(
        got[live], decode_attention_stacked_reference(q, k_all, v_all, lengths, 1)[live])
    for b, n in enumerate(lengths.tolist()):
        k_all[1, b, :, n:] = float("nan")
        v_all[1, b, :, n:] = float("nan")
    k_all[0] = float("nan")
    v_all[2] = float("nan")
    assert torch.equal(decode_attention_stacked(q, k_all, v_all, lengths, 1), got)


def test_decode_attention_on_a_side_stream(dev):
    """A launch inside torch.cuda.stream(s) reads what s wrote before it:
    the query and lengths are written on s behind ~0.1 s of spinning, so a
    launch on any other stream would read the old ones."""
    kc = _randn(dev, 2, 5, 512, 64, dtype=torch.bfloat16, seed=91)
    vc = _randn(dev, 2, 5, 512, 64, dtype=torch.bfloat16, seed=92)
    q = torch.zeros(2, 10, 64, device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    new_q = _randn(dev, 2, 10, 64, seed=93)
    new_lengths = torch.tensor([300, 511], dtype=torch.int32, device=dev)
    torch.cuda._sleep(1000)
    decode_attention(q, kc, vc, lengths)          # loaded before the test proper
    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)
        q.copy_(new_q)
        lengths.copy_(new_lengths)
        got = decode_attention(q, kc, vc, lengths)
    assert not side.query()
    side.synchronize()
    _assert_decode_close(got, decode_attention_reference(new_q, kc, vc, new_lengths))


def test_decode_attention_captured_in_a_cuda_graph(dev):
    """A decode launch captured in a CUDA graph and replayed with new
    lengths and queries attends the prefixes the lengths name."""
    kc = _randn(dev, 3, 5, 700, 64, dtype=torch.bfloat16, seed=94)
    vc = _randn(dev, 3, 5, 700, 64, dtype=torch.bfloat16, seed=95)
    q = _randn(dev, 3, 10, 64, seed=96)
    lengths = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):                 # warm-up outside the capture
        decode_attention(q, kc, vc, lengths)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, kc, vc, lengths)
    for step, lens in enumerate(([700, 65, 0], [129, 511, 64])):
        lengths.copy_(torch.tensor(lens, dtype=torch.int32, device=dev))
        q.copy_(_randn(dev, 3, 10, 64, seed=97 + step))
        graph.replay()
        torch.cuda.synchronize()
        live = lengths > 0
        _assert_decode_close(out[live], decode_attention_reference(q, kc, vc, lengths)[live])
        assert torch.equal(out[~live], torch.zeros_like(out[~live]))


def _kernel_events(fn) -> list:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0.0) and not e.key.startswith(("Memcpy", "Memset"))]


def test_decode_attention_is_one_kernel_launch(dev):
    """One call of each decode wrapper is one kernel event on the device
    (the profiler), the cluster's merge included."""
    q = _randn(dev, 1, 10, 64, seed=98)
    kc = _randn(dev, 1, 5, 4608, 64, dtype=torch.bfloat16, seed=99)
    lengths = torch.tensor([3072], dtype=torch.int32, device=dev)
    events = _kernel_events(lambda: decode_attention(q, kc, kc, lengths))
    assert [e.count for e in events] == [1], [(e.key, e.count) for e in events]
    assert "decode_attention_kernel" in events[0].key
    k_all = kc[None].repeat(2, 1, 1, 1, 1)
    events = _kernel_events(lambda: decode_attention_stacked(q, k_all, k_all, lengths, 1))
    assert [e.count for e in events] == [1], [(e.key, e.count) for e in events]


# B1 at the perception encoders' shapes (f32, as those models run)
@pytest.mark.parametrize("what,b,h,sq,sk,d,causal", [
    ("mask decoder cross-attention, head 32 padded to 64", 128, 8, 8, 257, 32, False),
    ("mask decoder self-attention, head 32 padded to 64", 128, 8, 8, 8, 32, False),
    ("byte ASR cross-attention, one query over 300 keys", 4, 4, 1, 300, 64, False),
    ("byte ASR teacher-forced decoder, causal", 4, 4, 96, 96, 64, True),
    ("retriever text tower, 64 positions", 64, 4, 64, 64, 64, False),
    ("segmenter image encoder, 256 tokens", 32, 6, 256, 256, 64, False),
    ("mini-SigLIP vision tower, 64 patches", 16, 6, 64, 64, 64, False),
    ("mini-SigLIP MAP head, one probe over 64 patches", 16, 6, 1, 64, 64, False),
    ("mini-SigLIP text tower, 32 byte positions", 24, 6, 32, 32, 64, False),
    ("VideoMAE, 392 tubelet tokens", 3, 4, 392, 392, 64, False),
    ("HiCo FRAME to CLIP pool, head 176 padded to 192", 4, 8, 1, 16, 176, False),
])
def test_flash_attention_at_the_encoder_shapes(dev, what, b, h, sq, sk, d, causal):
    q = _randn(dev, b, h, sq, d, seed=91)
    k = _randn(dev, b, h, sk, d, seed=92)
    v = _randn(dev, b, h, sk, d, seed=93)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches > before and got.shape == q.shape, what
    torch.testing.assert_close(got, attention_reference(q, k, v, causal=causal), **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [176, 192])
@pytest.mark.parametrize("hq,hkv,sq,sk,causal,kv_len", [
    (8, 8, 1, 16, False, None), (4, 2, 100, 100, True, None), (2, 1, 70, 130, False, 77),
    (4, 4, 33, 33, True, 20), (8, 8, 3, 64, False, 1)])
def test_flash_attention_at_the_wide_head(dev, dtype, d, hq, hkv, sq, sk, causal, kv_len):
    """B1 at HiCo's head of 176 (zero-padded to 192) and at 192 itself:
    one-query pools, causal tiles, kv_len past and inside a 32-key tile."""
    q = _randn(dev, 3, hq, sq, d, dtype=dtype, seed=41)
    k = _randn(dev, 3, hkv, sk, d, dtype=dtype, seed=42)
    v = _randn(dev, 3, hkv, sk, d, dtype=dtype, seed=43)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    assert flash_attention.launches == before + 1 and got.shape == q.shape
    want = attention_reference(q, k, v, causal=causal, kv_len=kv_len)
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32_TOL if dtype == torch.float32 else BF16_TOL))


def test_siglip_and_temporal_models_kernel_path_matches_plain_path(dev):
    """The mini-SigLIP pair, the clip classifier and HiCo's pool at their
    trained geometry, seeded random weights, through the flash kernel and
    through its plain version (``plain_attention``)."""
    from gvl_tpu_torch.nn.layers import init_state, load_module, plain_attention
    from gvl_tpu_torch.temporal.hico import HiCoConfig, HierarchicalCompressor, init_hico_state
    from gvl_tpu_torch.training import siglip_train, videomae_train

    gen = torch.Generator(device=dev).manual_seed(7)
    vcfg, tcfg = siglip_train.minisiglip_vision_config(), siglip_train.minisiglip_text_config()
    ccfg, hcfg = videomae_train.mini_videomae_config(), HiCoConfig()
    with torch.device("meta"):
        mini = siglip_train.MiniSigLIP(vcfg, tcfg)
        clf = videomae_train.ClipClassifier(ccfg)
        hico = HierarchicalCompressor(hcfg)
    mini = load_module(mini, init_state(mini, gen, dev), dev)
    clf = load_module(clf, init_state(clf, gen, dev), dev)
    hico = load_module(hico, init_hico_state(hcfg, gen, dev), dev)
    pixels = _randn(dev, 8, 128, 128, 3, seed=51).to(torch.bfloat16)
    ids = torch.randint(0, 256, (6, 32), generator=gen, device=dev)
    video = torch.randint(0, 256, (2, 16, 112, 112, 3), generator=gen, device=dev,
                          dtype=torch.uint8)
    frames = _randn(dev, 4, 16, 1408, seed=52)

    def run():
        return (mini.encode_image(pixels), mini.encode_text(ids),
                *clf(videomae_train._normalize(video)),
                hico.compress_frames_to_clip(frames), hico(frames))

    with torch.inference_mode():
        before = flash_attention.launches
        got = run()
        launched = flash_attention.launches - before
        with plain_attention():
            want = run()
        assert flash_attention.launches == before + launched
    # 6 + 1 vision, 4 text, 6 VideoMAE, 2 + 1 HiCo pools
    assert launched == 20
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32_TOL)


def test_perception_models_kernel_path_matches_plain_path(dev):
    """Each encoder on the card, seeded random weights, through the flash
    kernel and through its plain version (``set_flash_kernel``)."""
    from gvl_tpu_torch.models.sam import PromptableSegmenter, SamConfig
    from gvl_tpu_torch.models.siglip import SigLIPTextConfig, SigLIPTextTower
    from gvl_tpu_torch.models.whisper import WhisperModel, greedy_decode_cached
    from gvl_tpu_torch.nn.layers import init_state, load_module, set_flash_kernel
    from gvl_tpu_torch.training.asr_train import asr_config

    gen = torch.Generator(device=dev).manual_seed(0)

    def build(make):
        with torch.device("meta"):
            model = make()
        return load_module(model, init_state(model, gen, dev), dev)

    def both(model, *args, fn=None):
        fn = fn or model
        with torch.inference_mode():
            set_flash_kernel(model, True)
            before = flash_attention.launches
            got = fn(*args)
            assert flash_attention.launches > before
            set_flash_kernel(model, False)
            want = fn(*args)
            set_flash_kernel(model, True)
        return got, want

    sam = build(lambda: PromptableSegmenter(SamConfig()))
    got, want = both(sam, torch.rand(2, 256, 256, 3, generator=gen, device=dev),
                     torch.randint(1, 4096, (3, 16), generator=gen, device=dev))
    scale = want["mask_logits"].abs().max().item()
    torch.testing.assert_close(got["mask_logits"], want["mask_logits"], atol=1e-3 * scale,
                               rtol=0)
    torch.testing.assert_close(got["scores"], want["scores"], atol=1e-4, rtol=0)
    text = build(lambda: SigLIPTextTower(SigLIPTextConfig(
        hidden_size=256, intermediate_size=1024, num_layers=4, num_heads=4, vocab_size=256,
        max_position=64, projection_size=256)))
    got, want = both(text, torch.randint(0, 256, (8, 64), generator=gen, device=dev))
    torch.testing.assert_close(got["pooled"], want["pooled"], **F32_TOL)
    asr = build(lambda: WhisperModel(asr_config()))
    mel = torch.randn(2, 600, 80, generator=gen, device=dev)
    got, want = both(asr, mel, fn=asr.encoder)
    torch.testing.assert_close(got, want, **F32_TOL)
    prompts = torch.full((2, 1), 257, device=dev)
    got, want = both(asr, mel, prompts, 16,
                     fn=lambda m, p, n: greedy_decode_cached(asr, m, p, n))
    assert torch.equal(got, want)


def _hf_model(dev, gen, layout, convert, load):
    """A model of the HF rungs from seeded weights in its HF layout, through
    the port's converter, on the card."""
    from gvl_tpu_torch.models.hf_layouts import random_state

    return load(convert(random_state(layout, gen, dev)), dev)


def _kernel_and_plain(fn):
    """``fn()`` through the flash kernel and through its plain version, and
    the kernel launches of the first."""
    from gvl_tpu_torch.nn.layers import plain_attention

    with torch.inference_mode():
        before = flash_attention.launches
        got = fn()
        launched = flash_attention.launches - before
        with plain_attention():
            want = fn()
    return got, want, launched


def test_hf_audio_and_video_models_kernel_path_matches_plain_path(dev):
    """wav2vec2 (stable and post-norm), Whisper and VideoMAE, small, from
    HF-layout weights: the kernel path against the plain path on the card."""
    import dataclasses

    from gvl_tpu_torch.models import hf_layouts as L
    from gvl_tpu_torch.models import videomae, wav2vec2, whisper

    gen = torch.Generator(device=dev).manual_seed(8)
    for stable in (True, False):
        cfg = dataclasses.replace(wav2vec2.Wav2Vec2Config.tiny(stable), hidden_size=128,
                                  num_heads=2, num_layers=2)
        w2v = _hf_model(dev, gen, L.wav2vec2_layout(cfg),
                        lambda s: wav2vec2.convert_hf_wav2vec2(s, cfg),
                        lambda s, d: wav2vec2.load_wav2vec2(cfg, s, d))
        wav = torch.randn(2, 8000, generator=gen, device=dev)
        got, want, launched = _kernel_and_plain(lambda: w2v(wav)["last_hidden_state"])
        assert launched == 2
        torch.testing.assert_close(got, want, **F32_TOL)
    cfg = dataclasses.replace(whisper.WhisperConfig.tiny_random(), d_model=128, num_heads=2,
                              num_mel_bins=80, max_source_positions=300)
    asr = _hf_model(dev, gen, L.whisper_layout(cfg), lambda s: whisper.convert_hf_whisper(s, cfg),
                    lambda s, d: whisper.load_whisper(cfg, s, d))
    mel = torch.randn(1, 600, 80, generator=gen, device=dev)
    got, want, launched = _kernel_and_plain(lambda: asr.encoder(mel))
    assert launched == 1
    torch.testing.assert_close(got, want, **F32_TOL)
    prompt = torch.tensor([[50258, 50259]], device=dev)
    got, want, launched = _kernel_and_plain(
        lambda: whisper.greedy_decode_cached(asr, mel, prompt, 8))
    assert torch.equal(got, want) and launched >= 2
    cfg = dataclasses.replace(videomae.VideoMAEConfig.tiny(), hidden_size=128, num_heads=2)
    clip = _hf_model(dev, gen, L.videomae_layout(cfg),
                     lambda s: videomae.convert_hf_videomae(s, cfg),
                     lambda s, d: videomae.load_videomae(cfg, s, d))
    video = torch.randn(2, 4, 32, 32, 3, generator=gen, device=dev)
    got, want, launched = _kernel_and_plain(lambda: clip(video)["last_hidden_state"])
    assert launched == 1
    torch.testing.assert_close(got, want, **F32_TOL)


def test_hf_siglip_and_sam_models_kernel_path_matches_plain_path(dev):
    """The SigLIP pair (head 72, padded to 80) and SAM ViT from HF-layout
    weights, MiniLM beside them: kernel path against plain path on the card
    (SAM's and MiniLM's attention is plain on both, as in JAX)."""
    from gvl_tpu_torch.models import hf_layouts as L
    from gvl_tpu_torch.models import minilm, sam_vit, siglip

    gen = torch.Generator(device=dev).manual_seed(9)
    vcfg = siglip.SigLIPVisionConfig(hidden_size=144, intermediate_size=256, num_layers=2,
                                     num_heads=2, image_size=56)
    tower = _hf_model(dev, gen, L.siglip_vision_layout(vcfg),
                      lambda s: siglip.convert_hf_siglip_vision(s, vcfg),
                      lambda s, d: siglip.load_tower(vcfg, s, d))
    pixels = torch.randn(3, 56, 56, 3, generator=gen, device=dev)
    got, want, launched = _kernel_and_plain(lambda: tower(pixels)["pooled"])
    assert launched == 3
    torch.testing.assert_close(got, want, **F32_TOL)
    tcfg = siglip.SigLIPTextConfig.tiny(hidden_size=144, num_heads=2, projection_size=144)
    text = _hf_model(dev, gen, L.siglip_text_layout(tcfg),
                     lambda s: siglip.convert_hf_siglip_text(s, tcfg),
                     lambda s, d: siglip.load_text_tower(tcfg, s, d))
    ids = torch.randint(0, 256, (4, 16), generator=gen, device=dev)
    got, want, launched = _kernel_and_plain(lambda: text(ids)["pooled"])
    assert launched == 2
    torch.testing.assert_close(got, want, **F32_TOL)
    scfg = sam_vit.SamViTConfig(image_size=128, hidden_size=64, num_layers=2, num_heads=2,
                                mlp_dim=128, output_channels=32, window_size=4,
                                global_attn_indexes=(1,), prompt_hidden=32, num_pos_feats=16,
                                decoder_heads=2, decoder_mlp_dim=64, iou_head_hidden=32)
    sam = _hf_model(dev, gen, L.sam_layout(scfg), lambda s: sam_vit.convert_hf_sam(s, scfg),
                    lambda s, d: sam_vit.load_sam_vit(scfg, s, d))
    pixels = torch.randn(2, 128, 128, 3, generator=gen, device=dev)
    points = torch.rand(2, 4, 1, 2, generator=gen, device=dev) * 128
    labels = torch.ones(2, 4, 1, dtype=torch.int64, device=dev)
    got, want, launched = _kernel_and_plain(
        lambda: sam_vit.sam_predict(sam, pixels, points, labels))
    assert launched == 0 and got[0].shape == (2, 4, 3, 32, 32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    mcfg = minilm.MiniLMConfig.tiny()
    bert = _hf_model(dev, gen, L.bert_layout(mcfg), lambda s: minilm.convert_hf_bert(s, mcfg),
                     lambda s, d: minilm.load_minilm(mcfg, s, d))
    ids = torch.randint(0, 512, (3, 20), generator=gen, device=dev)
    got, want, launched = _kernel_and_plain(lambda: bert(ids))
    assert launched == 0 and torch.isfinite(got).all()


# B1 in Qwen3-VL's vision tower: head 72 (padded to 80 by the wrapper), not
# causal, one sequence of the 448- and 256-pixel frames' patches
@pytest.mark.parametrize("seq", [784, 256])
def test_flash_attention_at_the_qwen3vl_tower_shape(dev, seq):
    q, k, v = (_randn(dev, 1, 16, seq, 72, dtype=torch.bfloat16, seed=s) for s in (61, 62, 63))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1 and got.shape == q.shape
    torch.testing.assert_close(got.float(), attention_reference(q, k, v).float(), **BF16_TOL)


def _tiny_card_vl(dev, dtype):
    """A small Qwen3-VL whose heads the kernels take (64), seeded weights."""
    from gvl_tpu_torch.models.qwen3vl import Qwen3VLVisionConfig, init_vl_params

    vcfg = Qwen3VLVisionConfig(hidden_size=128, depth=3, num_heads=2, intermediate_size=256,
                               out_hidden_size=128, num_position_embeddings=64,
                               deepstack_visual_indexes=(0, 1))
    tcfg = Qwen3Config(hidden_size=128, num_layers=3, num_heads=4, num_kv_heads=2,
                       head_dim=64, intermediate_size=256, vocab_size=512,
                       max_cache_length=256)
    state = init_vl_params(vcfg, tcfg, torch.Generator(device=dev).manual_seed(3), dtype, dev)
    return vcfg, tcfg, state


def test_qwen3vl_kernel_path_matches_plain_path(dev):
    """The tower (B1 per block), the decoder's prefill with the mRoPE table
    and DeepStack (B1 per layer) and its decode steps (B2 and B3 per layer),
    each through the kernels and through their plain versions, f32 weights;
    the greedy tokens on bf16 caches equal."""
    import numpy as np

    from gvl_tpu_torch.models.qwen3vl import Qwen3VL, patchify_frames
    from gvl_tpu_torch.nn.layers import set_flash_kernel

    vcfg, tcfg, state = _tiny_card_vl(dev, torch.float32)
    vl = Qwen3VL(vcfg, tcfg, state, image_token_id=7, device=dev)
    plain = Qwen3VL(vcfg, tcfg.plain(), state, image_token_id=7, device=dev)
    set_flash_kernel(plain.vision, False)
    frame = np.random.default_rng(0).integers(0, 256, (1, 64, 96, 3), dtype=np.uint8)
    patches, grid = patchify_frames(frame, vcfg)
    n_vis = patches.shape[0] // 4
    ids = np.array([[11, 12, 5] + [7] * n_vis + [6] + list(range(20, 53))], np.int64)
    counters = (flash_attention, decode_attention, cache_append)
    before = [f.launches for f in counters]
    got_tower = vl.encode_vision(patches, grid)
    got_logits = vl.forward(ids, patches, grid)
    tokens = vl.generate(ids, patches, grid, max_new_tokens=6, eos_token_id=-1)
    launched = [f.launches - b for f, b in zip(counters, before)]
    # tower twice (encode_vision, forward) and once in generate's prefill
    assert launched == [3 * vcfg.depth + 2 * tcfg.num_layers, 5 * tcfg.num_layers,
                        5 * tcfg.num_layers]
    before = [f.launches for f in counters]
    want_tower = plain.encode_vision(patches, grid)
    want_logits = plain.forward(ids, patches, grid)
    want_tokens = plain.generate(ids, patches, grid, max_new_tokens=6, eos_token_id=-1)
    assert [f.launches for f in counters] == before
    torch.testing.assert_close(got_tower[0], want_tower[0], **F32_TOL)
    for g, w in zip(got_tower[1], want_tower[1]):
        torch.testing.assert_close(g, w, **F32_TOL)
    torch.testing.assert_close(got_logits, want_logits, **F32_TOL)
    assert tokens == want_tokens and len(tokens) == 6


def test_qwen3vl_generate_refuses_an_f32_cache_on_the_card(dev):
    """The decode kernel reads bf16 caches: an f32 cache raises, no cast."""
    import numpy as np

    from gvl_tpu_torch.models.qwen3vl import Qwen3VL

    vcfg, tcfg, state = _tiny_card_vl(dev, torch.bfloat16)
    vl = Qwen3VL(vcfg, tcfg, state, device=dev)
    before = decode_attention.launches
    with pytest.raises(ValueError, match="bf16"):
        vl.generate(np.array([[11, 12, 13]]), cache_dtype=torch.float32)
    assert decode_attention.launches == before
    assert len(vl.generate(np.array([[11, 12, 13]]), max_new_tokens=2, eos_token_id=-1)) == 2


# --------------------------------------------------------------------------
# Training: B1 under autograd (ops.attention.dot_product_attention)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,seq,causal,kv_len,launches", [
    (10, 5, 300, True, None, 1),       # dense backward: the forward alone
    (4, 2, 1100, True, None, 2),       # blockwise: the forward and delta's recompute
    (4, 4, 1040, False, 1001, 2),
])
def test_attention_function_under_autograd_matches_plain(dev, dtype, hq, hkv, seq, causal,
                                                          kv_len, launches):
    """The kernel path's output and q/k/v gradients against the same
    Function on the plain forward (the backward is the same plain code: the
    gradients differ only where the blockwise backward's delta reads the
    kernel's output); the plain path launches nothing."""
    from gvl_tpu_torch.ops.attention import dot_product_attention

    q = _randn(dev, 1, hq, seq, 64, dtype=dtype, seed=1)
    k, v = _randn(dev, 1, hkv, seq, 64, dtype=dtype, seed=2), _randn(dev, 1, hkv, seq, 64,
                                                                     dtype=dtype, seed=3)
    g = _randn(dev, 1, hq, seq, 64, seed=4)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    results = []
    for kernel in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = flash_attention.launches
        out = dot_product_attention(*leaves, causal=causal, kv_len=kv_len, kernel=kernel)
        (out.float() * g).sum().backward()
        torch.cuda.synchronize()
        results.append((out, [t.grad for t in leaves], flash_attention.launches - before))
    (out_k, grads_k, n_k), (out_p, grads_p, n_p) = results
    assert (n_k, n_p) == (launches, 0)
    torch.testing.assert_close(out_k, out_p, **tol)
    for a, b in zip(grads_k, grads_p):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, **tol)


def _train_launches(dev, cfg, seq, dtype=torch.bfloat16):
    """B1 launches of one loss and backward of a tiny model (and its
    parameters' gradients)."""
    from gvl_tpu_torch.models.qwen3 import init_jax_params, load_model
    from gvl_tpu_torch.training.qa_lm_train import qa_loss

    state = init_jax_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    model = load_model(cfg, state, dev)
    tokens = torch.randint(1, cfg.vocab_size, (2, seq), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    mask = torch.ones(2, seq, device=dev)
    before = flash_attention.launches
    qa_loss(model, tokens, mask, dtype).backward()
    torch.cuda.synchronize()
    return (flash_attention.launches - before,
            {n: p.grad for n, p in model.named_parameters()})


@pytest.mark.parametrize("remat,seq,per_layer", [(True, 1100, 3), (False, 1100, 2),
                                                 (False, 512, 1), (True, 512, 2)])
def test_training_step_launches_the_implied_b1_count(dev, remat, seq, per_layer):
    """Per layer: the forward, remat's recompute, and the blockwise backward's
    delta recompute past 1024^2 scores (chip_smoke phase 18's 30 per step at
    the QA model's 10 layers); the plain path none; serving one."""
    from gvl_tpu_torch.models.qwen3 import Qwen3Config, init_jax_params, load_model

    cfg = Qwen3Config.tiny(head_dim=64, remat=remat)
    n, _ = _train_launches(dev, cfg, seq)
    assert n == per_layer * cfg.num_layers
    assert _train_launches(dev, cfg.plain(), seq)[0] == 0
    model = load_model(cfg, init_jax_params(cfg, torch.Generator(device=dev), dev), dev)
    before = flash_attention.launches
    with torch.inference_mode():
        model(torch.ones(1, seq, dtype=torch.long, device=dev))
    assert flash_attention.launches - before == cfg.num_layers


def test_checkpointed_layers_give_the_same_gradients(dev):
    """remat recomputes each layer (its bf16 cast included) on the kernel
    path: the same gradients as the stored activations give."""
    from gvl_tpu_torch.models.qwen3 import Qwen3Config

    cfg = Qwen3Config.tiny(head_dim=64)
    _, plain = _train_launches(dev, cfg, 1100)
    from dataclasses import replace

    _, remat = _train_launches(dev, replace(cfg, remat=True), 1100)
    for name, g in plain.items():
        torch.testing.assert_close(remat[name], g, atol=1e-6, rtol=1e-5, msg=name)


# --------------------------------------------------------------------------
# The perception trainers (chip_smoke phase 19)
# --------------------------------------------------------------------------

PERCEPTION_TRAINERS = ("segmenter", "ocr recognizer", "ocr detector", "audio events",
                       "byte ASR", "SigLIP text pretraining", "mini-SigLIP", "retriever",
                       "VideoMAE", "HiCo")


@pytest.mark.parametrize("name", PERCEPTION_TRAINERS)
def test_perception_trainer_kernel_path_matches_plain(dev, name):
    """Each trainer at its default config: the kernel path's loss and every
    gradient within chip_smoke's PT_GRAD_REL of the plain path's at the
    drawn start, B1 launched as implied (none on the plain path)."""
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    case = next(c for c in chip_smoke.perception_trainer_cases(dev) if c.name == name)
    chip_smoke.kernel_against_plain(case, case.init(), case.batch(), dev)


def test_nccl_one_rank_tensor_parallel_is_bit_equal(dev, tmp_path):
    """A world of one rank over NCCL (a ``file://`` store): the decoder at a
    1 x 1 mesh, whose collectives run and sum one rank, gives the unsharded
    engine's logits bit for bit, prefill and greedy steps alike."""
    from gvl_tpu_torch.parallel.mesh import (
        MeshManager,
        build_mesh,
        init_distributed,
        shutdown_distributed,
    )

    init_distributed(init_method=f"file://{tmp_path}/store", world_size=1, rank=0,
                     local_rank=0, local_world_size=1, device="cuda")
    try:
        mm = MeshManager(build_mesh(1, 1))
        assert mm.backend == "nccl"
        cfg = Qwen3Config.tiny(num_heads=8, num_kv_heads=4, head_dim=128, hidden_size=256,
                               max_cache_length=256)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        alone = Qwen3Engine(cfg, params, eos_token_id=-1, device=dev)
        meshed = Qwen3Engine(cfg, params, eos_token_id=-1, device=dev, mesh=mm)
        tokens = torch.randint(0, cfg.vocab_size, (1, 40), device=dev)
        with torch.inference_mode():
            assert torch.equal(meshed.model(tokens)[0], alone.model(tokens)[0])
        prompt = tokens[0].tolist()
        assert meshed.generate(prompt, max_new_tokens=8, temperature=0.0) == \
            alone.generate(prompt, max_new_tokens=8, temperature=0.0)
    finally:
        shutdown_distributed()


def test_nccl_one_rank_lockstep_session_is_bit_equal(dev, tmp_path):
    """The batching engine's chat turns (``POST /chat`` under a mesh) in a
    world of one rank over NCCL: a session's two turns, greedy and sampled
    (T 0.7), give the tokens and prefilled counts of the session with no
    mesh, and its cache's live rows bit for bit."""
    from gvl_tpu_torch.models.session import Qwen3ChatSession
    from gvl_tpu_torch.parallel.mesh import (
        MeshManager,
        build_mesh,
        init_distributed,
        shutdown_distributed,
    )
    from gvl_tpu_torch.serving import ContinuousBatchingEngine

    init_distributed(init_method=f"file://{tmp_path}/store", world_size=1, rank=0,
                     local_rank=0, local_world_size=1, device="cuda")
    try:
        mm = MeshManager(build_mesh(1, 1))
        assert mm.backend == "nccl"
        cfg = Qwen3Config.tiny(num_heads=8, num_kv_heads=4, head_dim=128, hidden_size=256,
                               max_cache_length=256)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        engine = ContinuousBatchingEngine(cfg, params, eos_token_id=-1, num_slots=2,
                                          device=dev, mesh=mm)
        prompt = torch.randint(0, cfg.vocab_size, (40,),
                               generator=torch.Generator().manual_seed(1)).tolist()
        for temperature in (0.0, 0.7):
            alone = Qwen3ChatSession(cfg, params, eos_token_id=-1, device=dev)
            sid, ids = f"s{temperature}", prompt
            for tail in ([], [3, 4, 5]):
                ids = ids + tail
                turn = engine.submit_turn(sid, ids, 8, temperature=temperature)
                engine.step()
                want = alone.generate(ids, max_new_tokens=8, temperature=temperature)
                assert turn.error is None and turn.tokens == want
                assert turn.prefilled == alone.last_ingested
                ids = ids + want
            session = engine.sessions[sid]
            n = alone.cache.length
            assert session.cache.length == n
            for got, ref in zip(session.cache.k + session.cache.v,
                                alone.cache.k + alone.cache.v):
                assert torch.equal(got[..., :n, :], ref[..., :n, :])
    finally:
        shutdown_distributed()
