"""gvl_tpu_torch's plain versions of the fused W8A8 kernels (B7-B12)
against gvl_tpu/ops/quant_matmul.py, on the CPU.

Each plain version is held to the JAX package's XLA reference and to its
Pallas kernel run in interpret mode, on the cases of
tests/test_quant_fused.py.  Tolerances: int32 accumulations equal; int8
outputs at most 1 step apart on at most 0.1 % of the elements (exp2, rsqrt
and sums in another order can move a value across a rounding boundary);
bf16 outputs within 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.ops import quant_matmul as jq
from gvl_tpu_torch.ops import quant_matmul as tq

RNG = np.random.default_rng(0)


def _int8(shape, rng=RNG):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(a: np.ndarray):
    """The same bf16 values on both sides."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def assert_int8_close(got, want):
    got = np.asarray(got, np.int32)
    want = np.asarray(want, np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


def assert_int8_within_one(got, want):
    """For JAX's XLA attention references with a requantize: they round the
    attention output to bf16 before they quantize it, the Pallas bodies
    (and the port) do not, so about 2 % of the outputs sit one step apart
    (as the Pallas body's own do from that reference)."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()


def assert_bf16_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


# ------------------------------------------------------------------ B7

def _w8a8_operands(m, k, n, seed, spread=3.0):
    """Operands whose y = acc * scale spreads about +-spread (acc has a
    spread of about 5376 sqrt(K))."""
    rng = np.random.default_rng(seed)
    x, w = _int8((m, k), rng), _int8((k, n), rng)
    scale = (rng.uniform(0.5, 1.5, n) * spread / (5376 * np.sqrt(k))).astype(np.float32)
    bias = (rng.normal(size=n) * 0.1).astype(np.float32)
    res = rng.normal(size=(m, n)).astype(np.float32)
    return x, w, scale, bias, res


@pytest.mark.parametrize("epilogue,use_bias,m,k,n", [
    ("none", True, 64, 128, 256),
    ("none", False, 64, 128, 256),
    ("residual", True, 64, 128, 256),
    ("gelu_quant", True, 64, 128, 256),
    ("quant", True, 64, 128, 256),
    ("none", False, 96, 128, 384),        # the ragged grid of test_quant_fused
    ("gelu_quant", True, 96, 256, 384),
])
def test_w8a8_matmul_plain_matches_jax(epilogue, use_bias, m, k, n):
    x, w, scale, bias, res = _w8a8_operands(m, k, n, seed=m + k + n,
                                            spread=60.0 if epilogue == "quant" else 3.0)
    inv = 37.5
    res_j, res_t = _bf16(res)
    jkw = dict(epilogue=epilogue, out_scale_inv=jnp.float32(inv) if epilogue ==
               "gelu_quant" else None, residual=res_j if epilogue == "residual" else None)
    args_j = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
              jnp.asarray(bias) if use_bias else None)
    want = jq.w8a8_matmul_reference(*args_j, **jkw)
    pallas = jq.w8a8_matmul_pallas(*args_j, interpret=True,
                                   block_m=64 if m == 96 else 1024,
                                   block_n=256 if n == 384 else 512, **jkw)
    got = tq.w8a8_matmul(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
        torch.from_numpy(scale), torch.from_numpy(bias) if use_bias else None,
        epilogue=epilogue, out_scale_inv=inv if epilogue == "gelu_quant" else None,
        residual=res_t if epilogue == "residual" else None)
    if epilogue in ("gelu_quant", "quant"):
        assert got.dtype == torch.int8
        assert_int8_close(got.numpy(), want)
        assert_int8_close(got.numpy(), pallas)
    else:
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got.float().numpy(), _np(want))
        assert_bf16_close(got.float().numpy(), _np(pallas))


def test_int_matmul_accumulation_is_exact():
    x, w = _int8((64, 4352)), _int8((4352, 128))
    want = np.asarray(jnp.dot(jnp.asarray(x), jnp.asarray(w),
                              preferred_element_type=jnp.int32))
    got = tq.int_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gelu_exp2_matches_jax():
    y = np.linspace(-8, 8, 4001).astype(np.float32)
    got = tq.gelu_exp2(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jq._gelu_exp2(jnp.asarray(y))),
                               atol=1e-6, rtol=1e-6)


def test_w8a8_matmul_refuses_misuse():
    x = torch.zeros(32, 128, dtype=torch.int8)
    w = torch.zeros(128, 128, dtype=torch.int8)
    s = torch.ones(128)
    with pytest.raises(ValueError, match="out_scale_inv"):
        tq.w8a8_matmul(x, w, s, epilogue="gelu_quant")
    with pytest.raises(ValueError, match="residual"):
        tq.w8a8_matmul(x, w, s, epilogue="residual")
    with pytest.raises(ValueError, match="epilogue"):
        tq.w8a8_matmul(x, w, s, epilogue="relu")


@pytest.mark.parametrize("product,n", [("qkv", 6144), ("o-projection", 1152),
                                       ("fc1", 4352), ("fc2", 1152), ("region qkv", 6144),
                                       ("packed qkv", 3456)])
def test_w8a8_block_n_is_a_wgmma_width(product, n):
    """The tile width the wrapper picks for each served product is a width
    the kernel has (a wgmma N: a multiple of 16, at most 256) and divides N,
    so no tile of a served product is ragged."""
    bn = tq.w8a8_block_n(n)
    assert bn in tq.W8A8_BLOCK_N and bn % 16 == 0 and bn <= 256
    assert n % bn == 0
    assert tq.w8a8_block_n(4352) == tq.w8a8_block_n(6144) == 256


def _w8a8_args(m=32, k=128, n=128, **over):
    args = dict(x_q=torch.zeros(m, k, dtype=torch.int8), w_q=torch.zeros(n, k, dtype=torch.int8),
                scale=torch.ones(n), bias=None, residual=None, out_dtype=torch.bfloat16)
    args.update(over)
    return args


@pytest.mark.parametrize("k", [16, 48, 1152, 4352])
def test_w8a8_contract_takes_k_in_16_byte_steps(k):
    """TMA needs 16-byte row strides only, so K % 16 replaces K % 64."""
    assert tq._check_w8a8(**_w8a8_args(k=k)) == (32, 128, k)


@pytest.mark.parametrize("over,match", [
    (dict(k=40), "multiples of 16"),                  # K % 16 != 0
    (dict(k=8), "multiples of 16"),
    (dict(n=24), "multiples of 16"),                  # N % 16 != 0
    (dict(x_q=torch.zeros(32, 128, dtype=torch.int16)), "int8"),
    (dict(scale=torch.ones(128, dtype=torch.float64)), "f32 scale"),
    (dict(out_dtype=torch.float16), "f32 or bf16"),
    (dict(residual=torch.zeros(32, 128)), "residual"),
    (dict(x_q=torch.zeros(32 * 128 + 1, dtype=torch.int8)[1:].view(32, 128)), "aligned"),
])
def test_w8a8_contract_refuses_what_the_kernel_does_not_take(over, match):
    with pytest.raises(ValueError, match=match):
        tq._check_w8a8(**_w8a8_args(**over))


# ------------------------------------------------------------- B8, B11

@pytest.mark.parametrize("rows,d,dtype", [(64, 256, "bf16"), (96, 1152, "bf16"),
                                          (32, 128, "f32")])
def test_ln_quant_plain_matches_jax(rows, d, dtype):
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(rows, d)) * 2.0).astype(np.float32)
    g = rng.uniform(0.5, 1.5, d).astype(np.float32)
    b = (rng.normal(size=d) * 0.1).astype(np.float32)
    if dtype == "bf16":
        xj, xt = _bf16(x)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    inv = 40.0
    want = jq.ln_quant_reference(xj, jnp.asarray(g), jnp.asarray(b), jnp.float32(inv))
    pallas = jq.ln_quant_pallas(xj, jnp.asarray(g), jnp.asarray(b), jnp.float32(inv),
                                interpret=True)
    got = tq.ln_quant(xt, torch.from_numpy(g), torch.from_numpy(b), inv)
    assert got.dtype == torch.int8
    assert_int8_close(got.numpy(), want)
    assert_int8_close(got.numpy(), pallas)


@pytest.mark.parametrize("shape,inv", [((64, 128), 50.0), ((96, 1152), 20.0)])
def test_quant_static_plain_matches_jax(shape, inv):
    xj, xt = _bf16(np.random.default_rng(1).normal(size=shape).astype(np.float32))
    want = jq.quant_static_reference(xj, jnp.float32(inv))
    pallas = jq.quant_static_pallas(xj, jnp.float32(inv), interpret=True)
    got = tq.quant_static(xt, inv)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_int8_close(got.numpy(), pallas)


# ----------------------------------------------------------- B9, B10, B12

def _qkv(b, sp, h, dh, seed, pad_max_from=None):
    """bf16 qkv on both sides; with ``pad_max_from`` the rows from there on
    are scaled by 4, so that they hold the largest |x| of every slab."""
    x = np.random.default_rng(seed).normal(size=(b * sp, 3 * h * dh)).astype(np.float32)
    if pad_max_from is not None:
        x.reshape(b, sp, -1)[:, pad_max_from:] *= 4
    return _bf16(x)


@pytest.mark.parametrize("int8_scores", [False, True])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b,sp,kv_len,h,block_q,pad_max", [
    pytest.param(2, 64, 57, 4, 1024, False, id="2-64-57-4-1024"),
    pytest.param(1, 96, 81, 2, 32, False, id="1-96-81-2-32"),
    pytest.param(1, 96, 81, 2, 1024, True, id="1-96-81-2-1024-pad_max")])
def test_attention_fused_qkv_plain_matches_pallas(int8_scores, quant, b, sp, kv_len,
                                                  h, block_q, pad_max):
    """Padded heads (dh_pad 128): the plain version against the Pallas body
    in interpret mode, both int8_scores settings (JAX's XLA reference has
    no int8_scores), the kv_len mask, the fused requantize, one q block or
    three.  ``pad_max``: the rows at or past kv_len hold each slab's largest
    |x|, and int8_scores' k and v maxima must count them, as the TPU body's
    do (the kernel is held to that on the card)."""
    qkv_j, qkv_t = _qkv(b, sp, h, 128, seed=sp + h, pad_max_from=kv_len if pad_max else None)
    kw = dict(batch=b, seq_pad=sp, kv_len=kv_len, num_heads=h, dh_pad=128,
              sm_scale=1.0 / np.sqrt(72.0), int8_scores=int8_scores, block_q=block_q)
    inv = 40.0 if quant else None
    want = jq.attention_fused_qkv_pallas(
        qkv_j, interpret=True, out_scale_inv=None if inv is None else jnp.float32(inv),
        **kw)
    got = tq.attention_fused_qkv(qkv_t, out_scale_inv=inv, **kw)
    assert got.shape == (b * sp, h * 128)
    if quant:
        assert got.dtype == torch.int8
        assert_int8_close(got.numpy(), want)
    else:
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got.float().numpy(), _np(want))
    if not int8_scores:
        ref = jq.attention_fused_qkv_reference(
            qkv_j, **{k: v for k, v in kw.items() if k not in ("int8_scores", "block_q")},
            out_scale_inv=None if inv is None else jnp.float32(inv))
        if quant:
            assert_int8_within_one(got.numpy(), ref)
            assert_int8_within_one(want, ref)
        else:
            assert_bf16_close(got.float().numpy(), _np(ref))


@pytest.mark.parametrize("b,sp,kv_len,h,dh,inv", [
    (2, 64, 57, 8, 48, None),      # unaligned head_dim, garbage query rows
    (1, 32, 32, 4, 96, 40.0),      # the int8 epilogue
    (1, 96, 81, 16, 72, 40.0),     # so400m heads at the region canvas
    (1, 64, 60, 2, 128, None),
])
def test_attention_packed_multihead_plain_matches_jax(b, sp, kv_len, h, dh, inv):
    qkv_j, qkv_t = _qkv(b, sp, h, dh, seed=dh)
    kw = dict(batch=b, seq_pad=sp, kv_len=kv_len, num_heads=h, head_dim=dh,
              sm_scale=1.0 / np.sqrt(dh))
    jinv = None if inv is None else jnp.float32(inv)
    want = jq.attention_packed_multihead_pallas(qkv_j, interpret=True,
                                                out_scale_inv=jinv, **kw)
    ref = jq.attention_packed_multihead(qkv_j, out_scale_inv=jinv, **kw)
    got = tq.attention_packed_multihead(qkv_t, out_scale_inv=inv, **kw)
    assert got.shape == (b * sp, h * dh)
    if inv is not None:
        assert got.dtype == torch.int8
        assert_int8_close(got.numpy(), want)
        assert_int8_within_one(got.numpy(), ref)
    else:
        assert_bf16_close(got.float().numpy(), _np(want))
        assert_bf16_close(got.float().numpy(), _np(ref))


@pytest.mark.parametrize("b,sp,kv_len,h,dh", [(2, 64, 57, 4, 72), (1, 128, 128, 2, 128)])
def test_attention_qkv_packed_plain_matches_jax(b, sp, kv_len, h, dh):
    qkv_j, qkv_t = _qkv(b, sp, h, dh, seed=sp)
    kw = dict(batch=b, seq_pad=sp, kv_len=kv_len, num_heads=h, head_dim=dh,
              sm_scale=0.125)
    want = jq.attention_qkv_packed_pallas(qkv_j, interpret=True, **kw)
    ref = jq.attention_qkv_packed_reference(qkv_j, **kw)
    got = tq.attention_qkv_packed(qkv_t, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (b * sp, h * dh)
    assert_bf16_close(got.float().numpy(), _np(want))
    assert_bf16_close(got.float().numpy(), _np(ref))


def test_packed_and_padded_layouts_agree():
    """The same heads in the packed [.., 3·H·72] and the padded
    [.., 3·H·128] layout give the same attention (B10 against B9)."""
    b, sp, kv_len, h, dh = 2, 64, 57, 4, 72
    rng = np.random.default_rng(5)
    packed = rng.normal(size=(b * sp, 3, h, dh)).astype(np.float32)
    padded = np.zeros((b * sp, 3, h, 128), np.float32)
    padded[..., :dh] = packed
    _, p_t = _bf16(packed.reshape(b * sp, -1))
    _, d_t = _bf16(padded.reshape(b * sp, -1))
    kw = dict(batch=b, seq_pad=sp, kv_len=kv_len, num_heads=h,
              sm_scale=1.0 / np.sqrt(dh), out_scale_inv=40.0)
    got = tq.attention_packed_multihead(p_t, head_dim=dh, **kw)
    want = tq.attention_fused_qkv(d_t, dh_pad=128, **kw).view(b * sp, h, 128)[..., :dh]
    np.testing.assert_array_equal(got.view(b * sp, h, dh).numpy(), want.numpy())
