"""merkle_roofline.prove: % of the least time of the window's tree work
(every FRI layer's BLAKE2s tree to its root, a blob: 2^n, 2^(n-1), ...,
2^(n-n_inner) leaves; `portbench/roofline.py`) over the summed device time
of the records named in KERNELS."""

from portbench import roofline

KERNELS = ("merkle_level", "merkle_collapse")


def read(run):
    ms = run.trace.device_ms(*KERNELS)
    if run.card is None or ms <= 0:
        return None
    s = run.shapes()
    least = roofline.trees_ms([s["n"] - t for t in range(s["n_inner"] + 1)], run.card) * run.trace_blobs()
    return 100.0 * least / ms
