"""uint8 image and mask resize: the port's own copies of the JAX package's
native ``resize_u8`` and ``resize_nearest_u8``
(``gvl_tpu/runtime/csrc/gvl_runtime.cpp``), in numpy.

Area average when neither side grows, else bilinear with half-pixel
centres in 8.8 fixed point; coordinates in float32 as the C++ computes
them, so the bytes are the same as ``gvl_tpu.runtime.native.resize_image``.
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
