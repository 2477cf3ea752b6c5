"""grind_roofline.block9: % of the least time of the window's grinds over the
summed device time of the records named in KERNELS. The least time: each
proof's search from nonce 0 to its nonce, nonce + 1 compressions of
BLAKE2s-256 (one block: digest || nonce), at the mean of nonce + 1 over
every proof the program's counter `fri.grind_totals()` holds, times the
traced window's blobs (`portbench/roofline.py`). The counter counts every
proof since the process started (the warm-up's and the lead-in's too), so
its mean is over more proofs than the window's. On a program without the
counter the metric reads nothing. The port is imported here and not when
this file loads."""

from portbench import roofline

KERNELS = ("grind",)


def read(run):
    from frieda_tpu_torch.core import fri

    totals = getattr(fri, "grind_totals", None)
    counted = totals and totals()
    ms = run.trace.device_ms(*KERNELS)
    if not counted or not counted.proofs or run.card is None or ms <= 0:
        return None
    compressions = counted.nonces / counted.proofs * run.trace_blobs()
    return 100.0 * roofline.least_ms(0, compressions * roofline.BLAKE2S_COMPRESS_INSTR, run.card) / ms
