"""The device's idle share of the traced window, in %: 100 (1 - busy /
window), busy the union of the device's records inside the window."""


def read(run):
    if run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
