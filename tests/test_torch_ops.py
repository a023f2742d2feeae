"""gvl_tpu_torch ops against their gvl_tpu counterparts, on the CPU.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as the JAX package's own tests run them) and through the
port's plain PyTorch version, which is what the port's wrappers run on
CPU tensors.  f32 comparisons use atol 1e-5; a bf16 cache rounds the
softmax weights (and the reference's output) to bf16, so those cases
also state a bf16-sized tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.nn.layers import RMSNorm as JaxRMSNorm
from gvl_tpu.ops.attention import flash_attention as jax_flash
from gvl_tpu.ops.cache_update import cache_append as jax_cache_append
from gvl_tpu.ops.cache_update import cache_append_stacked as jax_cache_append_stacked
from gvl_tpu.ops.decode_attention import decode_attention as jax_decode
from gvl_tpu.ops.decode_attention import (
    decode_attention_reference as jax_decode_reference,
)
from gvl_tpu.ops.rope import apply_rope as jax_apply_rope
from gvl_tpu.ops.rope import rope_angles as jax_rope_angles
from gvl_tpu_torch.nn.layers import RMSNorm
from gvl_tpu_torch.ops.attention import attention_reference, flash_attention
from gvl_tpu_torch.ops.cache_update import (
    cache_append,
    cache_append_kv,
    cache_append_kv_reference,
    cache_append_reference,
    cache_append_stacked,
    cache_append_stacked_kv,
    cache_append_stacked_kv_reference,
)
from gvl_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from gvl_tpu_torch.ops.rope import apply_rope, rope_angles

F32_ATOL = 1e-5
BF16_ATOL = 2e-2   # a few units of bf16's 2**-8 relative precision on O(1) values


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 and back, so both frameworks see the same values."""
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.mark.parametrize("base", [10000.0, 100000.0])
def test_rope_matches_jax(base):
    pos = np.arange(37, dtype=np.int32) * 3
    cos, sin = rope_angles(torch.from_numpy(pos), 64, base)
    # against the float64 value of the same formula: f32 angles up to 108
    # rad carry ~4e-6 of rounding, so 1e-5 holds for an accurate f32 pow
    angles = pos[:, None] * base ** (-np.arange(32) / 32.0)
    angles = np.concatenate([angles, angles], axis=-1)
    np.testing.assert_allclose(cos.numpy(), np.cos(angles), atol=F32_ATOL)
    np.testing.assert_allclose(sin.numpy(), np.sin(angles), atol=F32_ATOL)
    # against JAX: in one multi-process test run the two differed by ~1.4e-6
    # relative in the frequency (alone they agree to 6e-8), an error the
    # angle multiplies; the float64 check above holds the port itself
    jcos, jsin = jax_rope_angles(jnp.asarray(pos), 64, base)
    tol = 4e-6 * (np.abs(angles).max() + 1.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=tol)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=tol)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 4, 37, 64)
    angles = rng.uniform(-50, 50, (37, 64)).astype(np.float32)
    cos, sin = np.cos(angles), np.sin(angles)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin))
    want = jax_apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("dim", [16, 640])
def test_rmsnorm_matches_jax(dim):
    rng = np.random.default_rng(1)
    x = _rand(rng, 3, 5, dim) * 3.0
    scale = _rand(rng, dim)
    norm = RMSNorm(dim)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x)).numpy()
    want = JaxRMSNorm().apply({"params": {"scale": jnp.asarray(scale)}},
                              jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL)


def test_rmsnorm_keeps_bf16():
    x = torch.randn(2, 8, generator=torch.Generator().manual_seed(0)).bfloat16()
    assert RMSNorm(8)(x).dtype == torch.bfloat16


# The TPU kernel masks padded keys in its last key block only, so kv_len is
# kept inside that block here; the port masks every key at or past kv_len.
@pytest.mark.parametrize(
    "hq,hkv,seq,causal,kv_len,block",
    [
        (4, 4, 48, False, None, 512),    # one block (single-block kernel)
        (4, 2, 48, True, None, 512),     # GQA, causal, one block
        (4, 1, 100, True, None, 32),     # several blocks, causal
        (2, 2, 100, False, 97, 32),      # several blocks, key padding
        (4, 2, 64, True, 50, 16),        # causal + key padding, GQA
    ],
)
def test_attention_reference_matches_flash_interpret(hq, hkv, seq, causal,
                                                     kv_len, block):
    rng = np.random.default_rng(seq + hq)
    q, k, v = (_rand(rng, 2, h, seq, 64) for h in (hq, hkv, hkv))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, kv_len=kv_len, block_q=block,
                     block_k=block, interpret=True)
    got = attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


def test_flash_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 2, 20, 16)) for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, kv_len=15)
    assert torch.equal(got, attention_reference(q, k, v, causal=True, kv_len=15))
    assert flash_attention.launches == before   # no kernel on the CPU


@pytest.mark.parametrize("lengths", [[1, 1], [100, 37], [256, 256], [5, 200]])
def test_decode_reference_matches_decode_interpret(lengths):
    rng = np.random.default_rng(sum(lengths))
    q = _rand(rng, 2, 8, 64)
    k, v = _rand(rng, 2, 2, 256, 64), _rand(rng, 2, 2, 256, 64)
    lens = np.asarray(lengths, np.int32)
    want = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(lens), block_k=64, interpret=True)
    got = decode_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("d,hq,hkv", [(64, 10, 5), (128, 8, 2)])
def test_decode_f32_query_over_bf16_cache(d, hq, hkv):
    """The QA path's mix: an f32 query against the engine's bf16 cache."""
    rng = np.random.default_rng(d)
    q = _rand(rng, 2, hq, d)
    k, v = _bf16(_rand(rng, 2, hkv, 192, d)), _bf16(_rand(rng, 2, hkv, 192, d))
    lens = np.asarray([70, 192], np.int32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    got = decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), torch.from_numpy(lens))
    assert got.dtype == torch.float32
    # same math as the JAX reference: bf16 rounding at the same places,
    # so only rare one-ulp rounding flips of the bf16 output may differ
    ref = jax_decode_reference(jq, jk, jv, jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=BF16_ATOL)
    assert np.mean(np.abs(got.numpy() - np.asarray(ref)) <= F32_ATOL) > 0.99
    # the TPU kernel rounds the weights but not its output to bf16
    kern = jax_decode(jq, jk, jv, jnp.asarray(lens), block_k=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=BF16_ATOL)


def test_decode_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_rand(rng, 1, 4, 64))
    k, v = (torch.from_numpy(_rand(rng, 1, 2, 32, 64)).bfloat16() for _ in range(2))
    lens = torch.tensor([9], dtype=torch.int32)
    before = decode_attention.launches
    got = decode_attention(q, k, v, lens)
    assert torch.equal(got, decode_attention_reference(q, k, v, lens))
    assert decode_attention.launches == before


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_cache_append_reference_matches_interpret(dtype):
    rng = np.random.default_rng(5)
    cache = _rand(rng, 2, 3, 32, 128)
    new = _rand(rng, 2, 3, 128)
    pos = np.asarray([0, 29], np.int32)
    if dtype == "bfloat16":
        cache, new = _bf16(cache), _bf16(new)
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    else:
        jdt, tdt = jnp.float32, torch.float32
    want = jax_cache_append(jnp.asarray(cache, jdt), jnp.asarray(new, jdt),
                            jnp.asarray(pos), interpret=True)
    got = cache_append_reference(torch.from_numpy(cache).to(tdt),
                                 torch.from_numpy(new).to(tdt),
                                 torch.from_numpy(pos))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # the pair form (one launch on the card) is the plain version applied
    # to K and to V: each equals the TPU kernel on its own cache
    v_cache, v_new = _rand(rng, 2, 3, 32, 128), _rand(rng, 2, 3, 128)
    if dtype == "bfloat16":
        v_cache, v_new = _bf16(v_cache), _bf16(v_new)
    want_v = jax_cache_append(jnp.asarray(v_cache, jdt), jnp.asarray(v_new, jdt),
                              jnp.asarray(pos), interpret=True)
    got_k, got_v = cache_append_kv(
        torch.from_numpy(cache).to(tdt), torch.from_numpy(v_cache).to(tdt),
        torch.from_numpy(new).to(tdt), torch.from_numpy(v_new).to(tdt),
        torch.from_numpy(pos))
    np.testing.assert_array_equal(got_k.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(got_v.float().numpy(),
                                  np.asarray(want_v.astype(jnp.float32)))


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_cache_append_stacked_kv_matches_interpret(dtype, layer):
    """The stacked pair form against the TPU kernel (interpret mode) on
    layer 0 and the last layer of K and of V."""
    rng = np.random.default_rng(6)
    caches = [_rand(rng, 3, 2, 2, 16, 128) for _ in range(2)]
    rows = [_rand(rng, 2, 2, 128) for _ in range(2)]
    pos = np.asarray([15, 4], np.int32)
    jdt, tdt = jnp.float32, torch.float32
    if dtype == "bfloat16":
        caches, rows = [_bf16(c) for c in caches], [_bf16(r) for r in rows]
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    got = cache_append_stacked_kv(*(torch.from_numpy(c).to(tdt) for c in caches),
                                  *(torch.from_numpy(r).to(tdt) for r in rows),
                                  torch.from_numpy(pos), layer)
    for cache, new, out in zip(caches, rows, got):
        want = jax_cache_append_stacked(jnp.asarray(cache, jdt), jnp.asarray(new, jdt),
                                        jnp.asarray(pos), jnp.int32(layer),
                                        interpret=True)
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def _rounding_cases(rng, shape) -> np.ndarray:
    """f32 rows whose bf16 rounding is hard: ties to even (low 16 bits
    0x8000, odd and even kept bit), one ulp either side of a tie, NaN,
    +-inf, the largest f32 (rounds up to inf), -0 and subnormals."""
    bits = rng.integers(0x0080, 0x7F7F, shape, dtype=np.uint32) << 16
    bits |= rng.choice(np.array([0x8000, 0x7FFF, 0x8001, 0x0000, 0x1234], np.uint32),
                       shape)
    bits[..., :2] |= np.uint32(0x80000000)                    # negative
    special = np.array([0x7FC00000, 0xFFC00001, 0x7F800000, 0xFF800000, 0x7F7FFFFF,
                        0x80000000, 0x00008000, 0x00018000, 0x3F808000, 0x3F818000],
                       np.uint32)
    bits.reshape(-1, shape[-1])[:, 2:2 + len(special)] = special
    return bits.view(np.float32)


def test_cache_append_kv_casts_f32_rows_like_jax_scatter():
    """f32 rows into a bf16 cache at head_dim 64 (the QA model's decode
    write): the port's pair form equals JAX's scatter path, which casts
    with ``.astype(bfloat16)`` and writes with ``.at[].set``, value for
    value, at rounding ties, NaN and inf included."""
    rng = np.random.default_rng(7)
    caches = [_bf16(_rand(rng, 2, 5, 24, 64)) for _ in range(2)]
    rows = [_rounding_cases(rng, (2, 5, 64)) for _ in range(2)]
    pos = np.asarray([0, 23], np.int32)
    got = cache_append_kv(*(torch.from_numpy(c).bfloat16() for c in caches),
                          *(torch.from_numpy(r) for r in rows), torch.from_numpy(pos))
    slot = jnp.arange(2)
    for cache, new, out in zip(caches, rows, got):
        want = jnp.asarray(cache, jnp.bfloat16).at[slot, :, jnp.asarray(pos), :].set(
            jnp.asarray(new).astype(jnp.bfloat16))
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
        # and bit for bit PyTorch's own cast of the rows, NaN kept a NaN
        written = out[torch.arange(2), :, torch.from_numpy(pos).long()]
        cast = torch.from_numpy(new).bfloat16()
        assert torch.equal(written.view(torch.int16), cast.view(torch.int16))
        assert torch.isnan(written).sum() == np.isnan(new).sum() > 0


def test_cache_append_on_cpu_copies_and_drops_out_of_range():
    cache = torch.zeros(2, 1, 4, 128)
    new = torch.ones(2, 1, 128)
    before = cache_append.launches
    got = cache_append(cache, new, torch.tensor([3, 4], dtype=torch.int32))
    assert cache_append.launches == before
    assert got.data_ptr() != cache.data_ptr() and cache.abs().sum() == 0
    assert got[0, 0, 3].eq(1).all() and got[0, 0, :3].eq(0).all()
    assert got[1].eq(0).all()   # position 4 is past S_max: nothing written


def test_pair_forms_on_cpu_write_in_place():
    """On CPU tensors the pair forms (the model's decode write) make the
    plain write into the caches themselves, as the kernel does on the card,
    and equal the plain versions' copies; out-of-range positions drop."""
    gen = torch.Generator().manual_seed(8)
    kc, vc = (torch.randn(2, 3, 8, 64, generator=gen).bfloat16() for _ in range(2))
    rows = [torch.randn(2, 3, 64, generator=gen) for _ in range(2)]
    pos = torch.tensor([7, 8], dtype=torch.int32)
    before = kc.clone()
    want = cache_append_kv_reference(kc, vc, *rows, pos)
    got = cache_append_kv(kc, vc, *rows, pos)
    assert got[0] is kc and got[1] is vc
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(kc[0], before[0])
    assert torch.equal(kc[1], before[1])          # position 8 is past S_max
    k_all, v_all = (torch.randn(3, 2, 3, 8, 64, generator=gen) for _ in range(2))
    want = cache_append_stacked_kv_reference(k_all, v_all, *rows, pos, 2)
    got = cache_append_stacked_kv(k_all, v_all, *rows, pos, 2)
    assert got[0] is k_all and got[1] is v_all
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_append_wrappers_refuse_what_the_kernel_does_not_take():
    """Checks that come before any launch, run here on meta tensors."""
    kc = torch.empty(2, 3, 16, 64, dtype=torch.bfloat16, device="meta")
    vc = torch.empty_like(kc)
    rows = torch.empty(2, 3, 64, device="meta")
    pos = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one tensor"):
        cache_append_kv(kc, kc, rows, rows, pos)
    stacked = kc[None].expand(3, -1, -1, -1, -1)
    with pytest.raises(ValueError, match="one tensor"):
        cache_append_stacked_kv(stacked, stacked, rows, rows, pos, 0)
    with pytest.raises(ValueError, match="f32 into a bf16 cache"):   # bf16 into f32
        cache_append_kv(kc.float(), vc.float(), rows.bfloat16(), rows.bfloat16(), pos)
    with pytest.raises(ValueError, match="f32 into a bf16 cache"):   # f32 into f16
        cache_append(kc.half(), rows, pos)
    with pytest.raises(ValueError, match="V rows"):
        cache_append_kv(kc, vc, rows, rows.bfloat16(), pos)
    with pytest.raises(ValueError, match="V cache"):
        cache_append_kv(kc, vc[:, :, :8], rows, rows, pos)
    with pytest.raises(ValueError, match="16-byte words"):      # bf16 rows of 8 bytes
        cache_append_kv(kc[..., :4], vc[..., :4], rows[..., :4], rows[..., :4], pos)
    with pytest.raises(ValueError, match="int32"):
        cache_append_kv(kc, vc, rows, rows, pos.long())
    with pytest.raises(ValueError, match="layer"):
        cache_append_stacked_kv(stacked, stacked.clone(), rows, rows, pos, 3)
    with pytest.raises(ValueError, match=r"\[L, B, Hkv, S_max, D\]"):
        cache_append_stacked(kc, rows, pos, 0)
    with pytest.raises(ValueError, match="CUDA"):                   # well formed
        cache_append_kv(kc, vc, rows, rows, pos)


def test_wrappers_refuse_other_devices():
    q = torch.empty(1, 2, 4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q[:, :, 0], q, q, torch.empty(1, dtype=torch.int32,
                                                       device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        cache_append(q, q[:, :, 0], torch.empty(1, dtype=torch.int32, device="meta"))
