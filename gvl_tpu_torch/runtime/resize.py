"""uint8 image and mask resize: the port's own copies of the JAX package's
native ``resize_u8`` and ``resize_nearest_u8``
(``gvl_tpu/runtime/csrc/gvl_runtime.cpp``), in numpy: the plain versions
that the tests hold the port's native build
(:mod:`gvl_tpu_torch.runtime.native`, which the pipeline calls) to.

Area average when neither side grows, else bilinear with half-pixel
centres in 8.8 fixed point; coordinates in float32 as the C++ computes
them, so the bytes are the same as ``gvl_tpu.runtime.native.resize_image``.

:func:`pil_bilinear` is a numpy copy of Pillow's ``Image.resize(size,
Image.BILINEAR)`` on uint8 RGB (Qwen3-VL's frame preparation, where the
JAX package calls Pillow; the card's machine has no Pillow).
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def _area_bounds(dst: int, src: int) -> tuple[np.ndarray, np.ndarray]:
    """Per destination index, the source span [lo, hi) it averages."""
    i = np.arange(dst, dtype=np.float32)
    f0 = i * _F(src) / _F(dst)
    f1 = (i + _F(1)) * _F(src) / _F(dst)
    lo = f0.astype(np.int64)
    hi = np.minimum((f1 + _F(0.9999)).astype(np.int64), src)
    hi = np.where(hi <= lo, lo + 1, hi)
    return lo, hi


def _bilinear_taps(dst: int, src: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per destination index: first source tap, second tap and the 8-bit
    weight of the second."""
    f = (np.arange(dst, dtype=np.float32) + _F(0.5)) * _F(src) / _F(dst) - _F(0.5)
    f = np.maximum(f, _F(0))
    i0 = f.astype(np.int64)
    i0 = np.minimum(i0, max(src - 2, 0))
    w = ((f - i0.astype(np.float32)) * _F(256.0)).astype(np.int64)
    i1 = i0 + (1 if src > 1 else 0)
    return i0, i1, w


def resize_image(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 ``[H, W]`` or ``[H, W, C]`` → ``[height, width, C]``."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 2:
        image = image[..., None]
    sh, sw, _ = image.shape
    if min(sh, sw, height, width) <= 0:
        raise ValueError(f"cannot resize {image.shape} to ({height}, {width})")
    if height <= sh and width <= sw:
        y0, y1 = _area_bounds(height, sh)
        x0, x1 = _area_bounds(width, sw)
        # box sums from an integral image (exact integers)
        acc_t = np.int32 if sh * sw * 255 < 2**31 else np.int64
        integral = np.zeros((sh + 1, sw + 1, image.shape[2]), acc_t)
        integral[1:, 1:] = image.cumsum(0, dtype=acc_t).cumsum(1, dtype=acc_t)
        acc = (integral[y1][:, x1] - integral[y0][:, x1]
               - integral[y1][:, x0] + integral[y0][:, x0])
        area = ((y1 - y0)[:, None] * (x1 - x0)[None, :])[..., None]
        return ((acc + area // 2) // area).astype(np.uint8)
    y0, y1, wy = _bilinear_taps(height, sh)
    x0, x1, wx = _bilinear_taps(width, sw)
    img = image.astype(np.int64)
    wx3, wy3 = wx[None, :, None], wy[:, None, None]
    top = img[y0][:, x0] * (256 - wx3) + img[y0][:, x1] * wx3
    bot = img[y1][:, x0] * (256 - wx3) + img[y1][:, x1] * wx3
    return ((top * (256 - wy3) + bot * wy3 + 32768) >> 16).astype(np.uint8)


def resize_mask(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """bool ``[H, W]`` → bool ``[height, width]`` by nearest neighbour: the
    port's copy of the JAX package's native ``resize_nearest_u8``
    (source index ``(i · src) // dst`` on each axis), so the cells are
    those of ``gvl_tpu.runtime.native.resize_mask``."""
    src = np.asarray(mask)
    sh, sw = src.shape
    if min(sh, sw, height, width) <= 0:
        raise ValueError(f"cannot resize {src.shape} to ({height}, {width})")
    ys = np.minimum(np.arange(height, dtype=np.int64) * sh // height, sh - 1)
    xs = np.minimum(np.arange(width, dtype=np.int64) * sw // width, sw - 1)
    return src.astype(bool)[ys][:, xs]


_PRECISION_BITS = 22        # Pillow's fixed point for 8-bit resampling


def _pil_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` for its triangle filter over the whole
    input, then ``normalize_coeffs_8bpc``: per output index the first input
    tap and the integer weights of ``ksize`` taps (zero past the last)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale          # the triangle's support is 1
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax, dtype=np.float64)
        w = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) / filterscale), 0.0)
        total = w.sum()
        if total != 0.0:
            w = w / total
        # (int)(0.5 + w * 2^22): the weights are never negative
        weights[xx, :xmax] = (0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)
        first[xx] = xmin
    return first, weights


def _pil_pass(image: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One of Pillow's separable passes along ``axis`` (0 rows, 1 columns):
    the weighted sum in fixed point from half a unit, shifted down and
    clipped to uint8."""
    first, weights = _pil_coeffs(image.shape[axis], out_size)
    taps = np.minimum(first[:, None] + np.arange(weights.shape[1]),
                      image.shape[axis] - 1)                 # [out, ksize]
    src = np.take(image.astype(np.int64), taps, axis=axis)   # the axis -> [out, ksize]
    shape = [1] * src.ndim
    shape[axis], shape[axis + 1] = weights.shape
    acc = (src * weights.reshape(shape)).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_bilinear(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 ``[H, W, C]`` resized to ``size = (width, height)`` as Pillow's
    ``Image.fromarray(image).resize(size, Image.BILINEAR)`` gives it, byte
    for byte: the triangle filter with its support widened by the reduction
    factor, weights in 22-bit fixed point, a horizontal pass then a vertical
    one (each skipped when its side keeps its size), each rounded and
    clipped to uint8."""
    image = np.ascontiguousarray(image, np.uint8)
    width, height = size
    if image.ndim != 3 or min(width, height, *image.shape[:2]) <= 0:
        raise ValueError(f"cannot resize {image.shape} to {size}")
    if width != image.shape[1]:
        image = _pil_pass(image, width, 1)
    if height != image.shape[0]:
        image = _pil_pass(image, height, 0)
    return image
