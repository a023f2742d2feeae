"""Build and load the CUDA kernels of ``gvl_tpu_torch/csrc``.

One ``nvcc`` command compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, which :func:`library` loads with
``ctypes``.  No source includes PyTorch's headers, so the build takes
seconds.

The library goes to ``gvl_tpu_torch/_build/<hash of the sources and
flags>/`` at first use.  It is written under a temporary name and renamed
into place, so a build that was cut off leaves no file that a later run
could take for a finished library, and no lock file to wait on.  A build
that fails or passes :data:`BUILD_TIMEOUT_S` raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libgvl_tpu_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 300

# element types as the C entry points number them (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VOID_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "gvl_flash_attention": [_VOID_P] * 4 + [_INT] * 8 + [_FLOAT, _INT, _VOID_P],
    "gvl_decode_attention": [_VOID_P] * 7 + [_INT] * 5 + [_FLOAT, _INT, _VOID_P],
    "gvl_decode_attention_chunk": [],
    "gvl_decode_attention_stacked": [_VOID_P] * 7 + [_INT] * 7 + [_FLOAT, _INT, _VOID_P],
    "gvl_chunk_attention": [_VOID_P] * 5 + [_INT] * 6 + [_FLOAT, _INT, _VOID_P],
    "gvl_cache_append": [_VOID_P] * 3 + [_INT] * 4 + [_VOID_P],
    "gvl_cache_append_stacked": [_VOID_P] * 3 + [_INT] * 6 + [_VOID_P],
}


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float        # nvcc wall time; 0.0 when the library was there
    command: tuple        # the nvcc command line, empty when cached


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Digest of every file in csrc/ and of the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> BuildResult:
    """The kernel library for the current sources, compiling it if needed."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return BuildResult(lib, 0.0, ())
    out_dir.mkdir(parents=True, exist_ok=True)
    partial = out_dir / f"{LIB_NAME}.partial-{os.getpid()}"
    cmd = (find_nvcc(), *NVCC_FLAGS, "-o", str(partial),
           *(str(p) for p in sources()))
    start = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc did not finish in {BUILD_TIMEOUT_S} s:\n{exc.stderr or ''}"
        ) from exc
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(partial, lib)
    return BuildResult(lib, seconds, cmd)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call in a process)."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    lib.gvl_error_string.argtypes = [_INT]
    lib.gvl_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        text = library().gvl_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({text})")


def stream_handle(device: torch.device) -> int:
    """The current PyTorch stream of ``device``, as a pointer-sized int."""
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: tensors must lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
