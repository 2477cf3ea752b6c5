"""lde_roofline.prove: % of the least time of the window's low-degree
extensions (4 columns of 2^log_size coefficients to 2^n evaluations a
blob; `portbench/roofline.py`) over the summed device time of the records
named in KERNELS."""

from portbench import roofline

KERNELS = ("fft_pass",)


def read(run):
    ms = run.trace.device_ms(*KERNELS)
    if run.card is None or ms <= 0:
        return None
    s = run.shapes()
    return 100.0 * roofline.lde_ms(s["log_size"], s["n"], run.card) * run.trace_blobs() / ms
