"""ingest_ms.prove: host ms a request of the program's span `prove/ingest` in the traced window (the blob's padding into words and its upload)."""

SPAN = "prove/ingest"


def read(run):
    spans = run.trace.span_ms(SPAN)
    if not spans:
        return None
    return sum(spans) / run.trace.requests
