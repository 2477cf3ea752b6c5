"""ingest_pin_ms.prove: host ms a request of the program's span `ingest/pin` in the traced window (the blob's host buffer taken from PyTorch's caching page-locked allocator, inside `prove/ingest`)."""

SPAN = "ingest/pin"


def read(run):
    spans = run.trace.span_ms(SPAN)
    if not spans:
        return None
    return sum(spans) / run.trace.requests
