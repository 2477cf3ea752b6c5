"""Hand-written CUDA kernels for Hopper (`csrc/`), each beside its plain
PyTorch version. A wrapper launches its kernel for a CUDA tensor and runs
the plain version for a CPU tensor, and counts its kernel launches in its
`launches` attribute."""

from __future__ import annotations


def kernel_wrappers() -> dict:
    """Name -> wrapper function of every kernel the commit and prove paths
    launch, their sharded forms (`parallel/`) included."""
    from .channel import grind, transcript
    from .fft import fft_exchange, fft_pass
    from .fri import fri_fold
    from .ingest import ingest
    from .merkle import merkle_collapse, merkle_level, merkle_open, merkle_open_queries, order_openings

    return {
        "ingest": ingest,
        "fft_pass": fft_pass,
        "merkle_level": merkle_level,
        "merkle_collapse": merkle_collapse,
        "merkle_open": merkle_open,
        "merkle_open_queries": merkle_open_queries,
        "order_openings": order_openings,
        "fri_fold": fri_fold,
        "transcript": transcript,
        "grind": grind,
        "fft_exchange": fft_exchange,
    }


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    """Every wrapper's count to 0, and `merkle_collapse.steps` (the
    collapses that carried a channel step)."""
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["merkle_collapse"].steps = 0


def add_launch_counts(counts: dict) -> None:
    """Add {name: n} to the wrappers' counts: a replayed CUDA graph's
    launches (`core/fri.py`), or the negated counts of a capture, whose
    wrapper calls record launches without running them."""
    wrappers = kernel_wrappers()
    for name, n in counts.items():
        wrappers[name].launches += n
