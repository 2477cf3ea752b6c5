"""setup_graph_s.prove: seconds of the program's spans `setup/graph` since
the process started (the captured commit phases' construction: the eager
warm-up commit and the CUDA graph's capture), read from the program's
in-memory table `utils/profiling.span_totals`, since no profiler runs
during set-up. The port is imported here and not when this file loads."""

SPAN = "setup/graph"


def read(run):
    from frieda_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    total = totals and totals().get(SPAN)
    return total.seconds if total else None
