"""Build, load and bind the port's CUDA kernels.

All kernels live in `frieda_tpu_torch/csrc/` and compile with `nvcc` into one
shared library with a plain C interface, loaded with `ctypes`: one `nvcc`
per source, all started together, then one link. The build runs
at first use, from the checkout's sources and nothing else, into
`build/kernels/<hash>/` at the repository root; the hash covers the sources
and the flags, so an edited source rebuilds and an unchanged one loads the
library already there. Nothing here runs at import time. `compile_once`
also builds the host runtime (`frieda_tpu_torch/native/`).
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

from ..utils.profiling import span

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("common.cuh", "blake2s.cuh", "fft.cu", "ingest.cu", "merkle.cu", "fri.cu", "channel.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libfrieda_torch_kernels.so"

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "frieda_ingest": (_VP, _VP, _I, _I, _LL, _I, _VP),
    "frieda_fft_pass": (_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP),
    "frieda_fft_pass_launch_shape": (_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)),
    "frieda_fft_exchange": (_VP, _VP, _VP, _I, _I, _LL, _LL, _I, _VP),
    "frieda_merkle_level": (_VP, _VP, _LL, _I, _I, _I, _VP),
    "frieda_merkle_collapse": (_VP, ctypes.POINTER(_VP), ctypes.POINTER(_LL), _I, _LL, _I, _I, _VP, _VP, _VP,
                               ctypes.c_uint, _VP),
    "frieda_merkle_open": (_VP, _I, _LL, _LL, _VP, _VP),
    "frieda_merkle_open_queries": (ctypes.POINTER(_VP), ctypes.POINTER(_VP), ctypes.POINTER(_VP),
                                   ctypes.POINTER(_I), ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(_LL),
                                   ctypes.POINTER(_LL), _I, _I, _VP, _I, _I, _LL, _VP, _VP),
    "frieda_order_openings": (_VP, _LL, _VP, _I, _I, _I, _LL, _LL, _LL, _I, _VP, _LL, _VP),
    "frieda_fri_fold": (_VP, _VP, _VP, _VP, _LL, _I, _LL, _LL, _VP),
    "frieda_transcript": (_VP, _I, ctypes.c_ulonglong, _VP, _VP, _VP, _I, _VP, ctypes.c_uint, _VP, _I, _I, _I,
                          _VP),
    "frieda_grind": (_VP, _I, _VP, _I, _I, _I, _I, _VP),
    "frieda_grind_shape": (ctypes.POINTER(_I), ctypes.POINTER(_I)),
}

_lib = None


def compile_once(out_root: pathlib.Path, lib_name: str, compiler: str, flags, sources) -> pathlib.Path:
    """Compile `sources` (paths; headers are hashed, not passed) into
    `out_root/<sha of the sources and flags>/lib_name`, unless that library
    is already there; returns its path. Every source compiles to an object
    at once, one compiler process each (`flags` without -shared, and -c),
    then one `compiler flags -o lib` links them. The compilers' output is
    kept beside it as build.log. A failed compile or link raises."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = out_root / h.hexdigest()[:16]
    so = out_dir / lib_name
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    with tempfile.TemporaryDirectory(dir=out_dir) as obj_dir:
        units = [s for s in sources if s.suffix in (".cu", ".cpp")]
        objs = [str(pathlib.Path(obj_dir) / f"{s.name}.o") for s in units]
        compile_flags = [f for f in flags if f != "-shared"] + ["-c"]
        cmds = [[compiler, *compile_flags, str(s), "-o", o] for s, o in zip(units, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        log, failed = [], None
        for cmd, proc in zip(cmds, procs):
            out = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode and failed is None:
                failed = (proc.returncode, out)
        if failed is None:
            link = [compiler, *flags, "-o", tmp, *objs]
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout)
            if proc.returncode:
                failed = (proc.returncode, proc.stdout)
    (out_dir / "build.log").write_text("".join(log))
    if failed is not None:
        pathlib.Path(tmp).unlink(missing_ok=True)  # a failed link has removed it already
        raise RuntimeError(f"{pathlib.Path(compiler).name} failed ({failed[0]}):\n{failed[1][-4000:]}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


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
    return compile_once(BUILD_ROOT, LIB_NAME, _nvcc(), NVCC_FLAGS, [CSRC / s for s in SOURCES])


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use; the first call is the
    span "setup/kernels")."""
    global _lib
    if _lib is None:
        with span("setup/kernels"):
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
