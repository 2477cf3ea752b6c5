"""Hand-written CUDA kernels for Hopper (`csrc/`), each beside its plain
PyTorch version. A wrapper launches its kernel for a CUDA tensor and runs
the plain version for a CPU tensor, and counts its kernel launches in its
`launches` attribute."""

from __future__ import annotations


def kernel_wrappers() -> dict:
    """Name -> wrapper function of every kernel the commit path launches."""
    from .fft import fft_pass
    from .ingest import ingest
    from .merkle import merkle_collapse, merkle_level

    return {
        "ingest": ingest,
        "fft_pass": fft_pass,
        "merkle_level": merkle_level,
        "merkle_collapse": merkle_collapse,
    }


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
