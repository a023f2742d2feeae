"""Native host runtime: C++ decoders and prefetch, via ctypes (counterpart
of :mod:`gvl_tpu.runtime`).  The library builds with ``g++`` at its first
use, never at import."""

from gvl_tpu_torch.runtime.native import (
    NativePrefetchSource,
    NativeY4MReader,
    native_available,
    read_wav_native,
)

__all__ = [
    "native_available",
    "NativeY4MReader",
    "NativePrefetchSource",
    "read_wav_native",
]
