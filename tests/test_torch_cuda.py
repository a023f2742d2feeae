"""gvl_tpu_torch's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with nvcc (sm_90a) and skip elsewhere:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX, which the port does not need.)

Tolerances: f32 1e-4 (sums in another order); bf16 2e-2 absolute and
relative (the softmax weights and outputs round to bf16 at other places).
"""

import pytest
import torch

from gvl_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Engine, init_params
from gvl_tpu_torch.ops.attention import attention_reference, flash_attention
from gvl_tpu_torch.ops.cache_update import cache_append, cache_append_reference
from gvl_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)

pytestmark = pytest.mark.cuda

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


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
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
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


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = _randn(dev, 1, 2, 8, 32)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bf16"):
        decode_attention(q[:, :, 0].contiguous(), q, q,
                         torch.ones(1, dtype=torch.int32, device=dev))
    cache = _randn(dev, 1, 1, 4, 128)
    with pytest.raises(ValueError, match="int32"):
        cache_append(cache, cache[:, :, 0].contiguous(),
                     torch.zeros(1, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3), q, q)


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
