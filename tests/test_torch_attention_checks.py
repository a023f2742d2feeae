"""The attention wrappers' own logic on the CPU: the shape checks that
decide what the flash and decode kernels take, and the limit that
chip_smoke.py and tests/test_torch_cuda.py hold the decode kernel to (the
kernels run on the card, in tests/test_torch_cuda.py)."""

import math

import numpy as np
import pytest
import torch

from chip_smoke import decode_tol
from gvl_tpu_torch.ops import attention, decode_attention as da

# the timed decode shapes of chip_smoke.py: the QA decode (f32 q over a bf16
# cache, one slot of 3072 live rows) and the 8B scan decode (bf16, 4 slots)
DECODE_SHAPES = {
    "QA": (torch.float32, 10, 5, 4608, 64, [3072]),
    "8B": (torch.bfloat16, 32, 8, 1024, 128, [129, 134, 140, 144]),
}
SPLIT, WARPS = 8, 4   # the kernel's blocks per (slot, KV head), warps per block


def _decode_inputs(shape):
    qdtype, hq, hkv, s_max, d, lens = DECODE_SHAPES[shape]
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((len(lens), hq, d))).to(qdtype)
    kc, vc = (torch.from_numpy(rng.standard_normal((len(lens), hkv, s_max, d)))
              .to(torch.bfloat16) for _ in range(2))
    return q, kc, vc, torch.tensor(lens, dtype=torch.int32)


def _weighted_decode(q, kc, vc, weights):
    """Decode attention in f64 with key i of slot b weighted by weights[b, i]
    (0 drops it, 2 counts it twice in the numerator and the denominator),
    the softmax weights rounded to bf16 before P V, as the kernel rounds
    them; the result in q's type (the kernel's output)."""
    batch, hq, d = q.shape
    hkv = kc.shape[1]
    qg = q.double().reshape(batch, hkv, hq // hkv, d)
    scores = qg @ kc.double().transpose(-1, -2) / math.sqrt(d)
    scores = scores + weights.double().log()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16).double()
    return (probs @ vc.double()).reshape(batch, hq, d).to(q.dtype)


def _decode_fault(name, lengths, s_max, tile):
    """Per-key weights [B, S_max] of a correct kernel ("exact") or of one
    fault of the cluster's split: block r takes keys [r s, (r + 1) s),
    s = ceil(len / 8), and warp w its tiles w, w + 4, ... of ``tile`` keys."""
    weights = (torch.arange(s_max)[None, :] < lengths[:, None]).double()
    for b, n in enumerate(lengths.tolist()):
        s = -(-n // SPLIT)
        if name == "a lost key at a share's start":
            weights[b, 3 * s] = 0
        elif name == "a lost warp tile in every share":
            for r in range(SPLIT):
                weights[b, r * s:min(r * s + tile, n)] = 0
        elif name == "a lost warp tile in one share":
            weights[b, 3 * s:3 * s + tile] = 0
        elif name == "one warp's partial counted twice":
            for t in range(1, -(-s // tile), WARPS):
                weights[b, 3 * s + t * tile:min(3 * s + (t + 1) * tile, 4 * s, n)] *= 2
    return weights


def _decode_excess(got, want):
    """max |got - want| / limit of decode_tol: at most 1 passes."""
    atol, rtol = decode_tol(want)
    return ((got.float() - want.float()).abs()
            / (atol + rtol * want.float().abs())).max().item()


@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
def test_decode_tol_passes_an_exact_evaluation(shape):
    """The f64 evaluation in the kernel's output type differs from the plain
    version only by rounding, and stays well inside the limit."""
    q, kc, vc, lengths = _decode_inputs(shape)
    want = da.decode_attention_reference(q, kc, vc, lengths)
    exact = _weighted_decode(q, kc, vc, _decode_fault("exact", lengths, kc.shape[2], 16))
    excess = _decode_excess(exact, want)
    print(f"{shape} exact: error / limit {excess:.3g}")
    assert excess <= 0.5, excess


@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
@pytest.mark.parametrize("fault", ["a lost key at a share's start",
                                   "a lost warp tile in every share",
                                   "a lost warp tile in one share",
                                   "one warp's partial counted twice"])
def test_decode_tol_catches_a_faulty_split(shape, fault):
    """A kernel that drops keys of the split, or weights one warp's keys
    twice, goes past the limit (warp tiles of 16 keys, 8 at head_dim 128)."""
    q, kc, vc, lengths = _decode_inputs(shape)
    want = da.decode_attention_reference(q, kc, vc, lengths)
    tile = 16 if q.shape[-1] == 64 else 8
    got = _weighted_decode(q, kc, vc, _decode_fault(fault, lengths, kc.shape[2], tile))
    excess = _decode_excess(got, want)
    print(f"{shape} {fault}: error / limit {excess:.3g}")
    assert excess > 1.5, excess


def _decode_operands(batch=2, hq=10, hkv=5, s_max=64, d=64, qdtype=torch.float32):
    q = torch.zeros(batch, hq, d, dtype=qdtype)
    kc = torch.zeros(batch, hkv, s_max, d, dtype=torch.bfloat16)
    return q, kc, kc.clone(), torch.ones(batch, dtype=torch.int32)


def test_check_decode_gives_the_kernels_arguments():
    """(B, Hq, Hkv, S_max, D, scale, q_dtype code): what the C entry points
    take after the pointers, for one layer's caches and a stack of them."""
    for kw, code in (({}, 0), (dict(hq=32, hkv=8, d=128, qdtype=torch.bfloat16), 1),
                     (dict(hq=8, hkv=1), 0)):
        q, kc, vc, lengths = _decode_operands(**kw)
        d = q.shape[-1]
        want = (2, q.shape[1], kc.shape[1], 64, d, 1.0 / math.sqrt(d), code)
        assert da._check_decode("decode_attention", q, kc, vc, lengths, None) == want
        stack = kc[None].expand(3, *kc.shape)
        assert da._check_decode("x", q, stack, stack, lengths, None, dims=5) == want
    assert da._check_decode("decode_attention", q, kc, vc, lengths, 0.5)[5] == 0.5
    with pytest.raises(ValueError, match="unsupported shapes"):
        da._check_decode("x", q, kc, vc, lengths, None, dims=5)


@pytest.mark.parametrize("change,match", [
    (dict(qdtype=torch.float16), "f32 or bf16"),
    (dict(d=96), "unsupported shapes"),
    (dict(hq=18, hkv=2), "unsupported shapes"),       # 9 query heads per KV head
    (dict(hq=10, hkv=4), "unsupported shapes"),
])
def test_check_decode_refuses(change, match):
    q, kc, vc, lengths = _decode_operands(**change)
    with pytest.raises(ValueError, match=match):
        da._check_decode("decode_attention", q, kc, vc, lengths, None)


def test_check_decode_refuses_cache_and_lengths():
    q, kc, vc, lengths = _decode_operands()
    with pytest.raises(ValueError, match="bf16"):
        da._check_decode("x", q, kc.float(), vc, lengths, None)
    with pytest.raises(ValueError, match="int32"):
        da._check_decode("x", q, kc, vc, lengths.long(), None)
    with pytest.raises(ValueError, match="int32"):
        da._check_decode("x", q, kc, vc, lengths[:1], None)
    with pytest.raises(ValueError, match="unsupported shapes"):
        da._check_decode("x", q, kc, vc[:, :, :32].contiguous(), lengths, None)


@pytest.mark.parametrize("head_dim,padded", [(64, 64), (128, 128), (72, 80), (16, 64),
                                             (80, 80), (96, 128)])
def test_check_flash_pads_the_head(head_dim, padded):
    q = torch.zeros(1, 4, 3, head_dim, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 5, head_dim, dtype=torch.bfloat16)
    assert attention._check_flash(q, k, k) == padded


@pytest.mark.parametrize("q_shape,k_shape,dtypes,match", [
    ((1, 4, 3, 256), (1, 2, 5, 256), (torch.float32,) * 3, "head_dim"),
    ((1, 4, 3, 64), (1, 2, 5, 64), (torch.float16,) * 3, "f32 or bf16"),
    ((1, 4, 3, 64), (1, 2, 5, 64), (torch.float32, torch.bfloat16, torch.float32),
     "f32 or bf16"),
    ((1, 4, 3, 64), (1, 3, 5, 64), (torch.float32,) * 3, "shapes"),
    ((2, 4, 3, 64), (1, 2, 5, 64), (torch.float32,) * 3, "shapes"),
    ((1, 4, 0, 64), (1, 2, 5, 64), (torch.float32,) * 3, "shapes"),
    ((1, 4, 3, 64), (1, 2, 5, 32), (torch.float32,) * 3, "head_dim"),
])
def test_check_flash_refuses(q_shape, k_shape, dtypes, match):
    q = torch.zeros(q_shape, dtype=dtypes[0])
    k = torch.zeros(k_shape, dtype=dtypes[1])
    v = torch.zeros(k_shape, dtype=dtypes[2])
    with pytest.raises(ValueError, match=match):
        attention._check_flash(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim,padded,offset", [(72, 80, 0), (72, 128, 0), (16, 64, 0),
                                                    (3, 64, 0), (72, 80, 1)])
def test_pad_head_is_a_zero_pad(dtype, head_dim, padded, offset):
    """In 8-byte units or element by element (rows or offsets that do not
    divide), the same zeros after the same values."""
    flat = torch.randn(offset + 2 * 3 * 5 * head_dim).to(dtype)
    t = flat[offset:].view(2, 3, 5, head_dim)
    got = attention._pad_head(t, padded)
    assert got.shape == (2, 3, 5, padded) and got.dtype == dtype
    assert torch.equal(got, torch.nn.functional.pad(t, (0, padded - head_dim)))
