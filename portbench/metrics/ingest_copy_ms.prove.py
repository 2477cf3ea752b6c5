"""ingest_copy_ms.prove: host ms a request of the program's span `ingest/copy` in the traced window (the blob's bytes copied into the page-locked buffer and its tail zeroed, inside `prove/ingest`)."""

SPAN = "ingest/copy"


def read(run):
    spans = run.trace.span_ms(SPAN)
    if not spans:
        return None
    return sum(spans) / run.trace.requests
