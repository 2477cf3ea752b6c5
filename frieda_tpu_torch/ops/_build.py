"""Build, load and bind the port's CUDA kernels.

All kernels live in `frieda_tpu_torch/csrc/` and compile with `nvcc` into one
shared library with a plain C interface, loaded with `ctypes`. The build runs
at first use, from the checkout's sources and nothing else, into
`build/kernels/<hash>/` at the repository root; the hash covers the sources
and the flags, so an edited source rebuilds and an unchanged one loads the
library already there. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("common.cuh", "blake2s.cuh", "fft.cu", "ingest.cu", "merkle.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libfrieda_torch_kernels.so"

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "frieda_ingest": (_VP, _VP, _I, _VP),
    "frieda_fft_pass": (_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP),
    "frieda_merkle_level": (_VP, _VP, _LL, _I, _I, _VP),
    "frieda_merkle_collapse": (_VP, ctypes.POINTER(_VP), ctypes.POINTER(_LL), _I, _LL, _VP),
}

_lib = None


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> pathlib.Path:
    """Compile the kernels unless this source hash is already built; returns
    the library path. The compiler's output (-Xptxas -v: registers, shared
    memory, spills per kernel) is kept beside it as build.log."""
    out_dir = BUILD_ROOT / source_digest()
    so = out_dir / LIB_NAME
    if so.exists():
        return so
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp] + [
        str(CSRC / s) for s in SOURCES if s.endswith(".cu")
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.frieda_error_string.argtypes = [ctypes.c_int]
        lib.frieda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(code: int) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError()
    right after the launch: a refused launch never runs, and a later
    synchronize would not report it)."""
    if code != 0:
        msg = library().frieda_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({code})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_u32(t: torch.Tensor, name: str, shape: tuple) -> None:
    """Kernel operand check: int32 (u32 bits), the given shape, contiguous,
    on the CPU or a CUDA device."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32 (u32 bits), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def check_same_device(*ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"operands on different devices: {[str(t.device) for t in ts]}")
