"""enqueue_ms.prove: host ms a request of the program's span `prove/device_dispatch(lde+merkle+transcript+grind)` in the traced window (the commit phase's dispatch: seed words and the graph replay's enqueue; a capture shows here)."""

SPAN = "prove/device_dispatch(lde+merkle+transcript+grind)"


def read(run):
    spans = run.trace.span_ms(SPAN)
    if not spans:
        return None
    return sum(spans) / run.trace.requests
