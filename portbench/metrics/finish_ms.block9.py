"""finish_ms.block9: host ms a request of the program's span `batch/finish`
in the traced window (a batch's finishes in `prove_many_sharded`: its one
fetch, which waits for the batch's graph replay, and every blob's proof
assembled on the host)."""

SPAN = "batch/finish"


def read(run):
    spans = run.trace.span_ms(SPAN)
    if not spans:
        return None
    return sum(spans) / run.trace.requests
