"""WAV decoding and polyphase resampling in numpy: the port's copies of the
JAX package's native ``wav_read`` (``gvl_tpu/runtime/csrc/gvl_runtime.cpp``)
and of the ``scipy.signal.resample_poly`` call its audio preprocessor makes.
``read_wav`` is the plain version of the port's native reader
(:func:`gvl_tpu_torch.runtime.native.read_wav_native`).
"""

from __future__ import annotations

import math
import struct
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Mono float32 samples and the sample rate of a PCM16/24/32 or float32
    WAV file: channels summed in double precision and divided by their
    count, as ``gvl_tpu.runtime.native.read_wav_native`` decodes them (the
    same float32 values).  Raises ``ValueError`` where that reader fails."""
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    fmt = channels = bits = rate = 0
    data = b""
    pos = 12
    while pos + 8 <= len(raw):
        tag, size = raw[pos:pos + 4], struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        pos += 8
        if tag == b"fmt ":
            fmt, channels, rate, _, _, bits = struct.unpack("<HHIIHH", raw[pos:pos + 16])
            pos += max(size, 16)
        elif tag == b"data":
            data = raw[pos:pos + size]
            if len(data) != size:
                raise ValueError(f"short data chunk in {path}")
            break
        else:
            pos += size + (size & 1)
    if not data or channels == 0 or rate == 0:
        raise ValueError(f"no audio in {path}")
    width = bits // 8
    frames = len(data) // (width * channels)
    b = np.frombuffer(data, np.uint8)[: frames * channels * width].reshape(-1, width)
    if fmt == 3 and bits == 32:
        s = b.copy().view("<f4")[:, 0].astype(np.float64)
    elif bits == 16:
        s = b.copy().view("<i2")[:, 0] / 32768.0
    elif bits == 24:
        v = (b[:, 0].astype(np.int32) << 8 | b[:, 1].astype(np.int32) << 16
             | b[:, 2].astype(np.int32) << 24) >> 8
        s = v / 8388608.0
    elif bits == 32:
        s = b.copy().view("<i4")[:, 0] / 2147483648.0
    else:
        s = np.zeros(len(b))
    s = s.reshape(frames, channels)
    acc = np.zeros(frames)
    for c in range(channels):           # the C++ order of the sum
        acc += s[:, c]
    return (acc / channels).astype(np.float32), int(rate)


def _kaiser_lowpass(numtaps: int, cutoff: float, beta: float = 5.0) -> np.ndarray:
    """``scipy.signal.firwin(numtaps, cutoff, window=("kaiser", beta))``:
    windowed sinc, scaled to unit gain at DC."""
    m = np.arange(numtaps) - 0.5 * (numtaps - 1)
    h = cutoff * np.sinc(cutoff * m) * np.kaiser(numtaps, beta)
    return h / h.sum()


def resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """``scipy.signal.resample_poly(x, up, down)`` for a 1-D signal (Kaiser
    beta 5 low-pass of half-length 10·max(up, down), zero padding): the
    filter in x's type as scipy casts it, the filtering in float64."""
    x = np.asarray(x)
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x.copy()
    n_in = len(x)
    n_out = -(-n_in * up // down)
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = _kaiser_lowpass(2 * half_len + 1, 1.0 / max_rate).astype(x.dtype) * up
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    hp = np.concatenate([np.zeros(n_pre_pad), h.astype(np.float64)])
    # polyphase: output m reads input n through filter tap m·down − n·up
    pos = (np.arange(n_out) + n_pre_remove) * down
    n = pos[:, None] // up - np.arange(-(-len(hp) // up))[None, :]
    j = pos[:, None] - n * up
    valid = (n >= 0) & (n < n_in) & (j < len(hp))
    taps = np.where(valid, hp[np.where(valid, j, 0)], 0.0)
    y = (taps * x.astype(np.float64)[np.where(valid, n, 0)]).sum(1)
    return y.astype(np.result_type(x.dtype, h.dtype))
