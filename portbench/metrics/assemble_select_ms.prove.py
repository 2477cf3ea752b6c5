"""assemble_select_ms.prove: host ms a request of the program's span `assemble/select` in the traced window (the witnesses selected from the fetched vector, inside `prove/assemble`)."""

SPAN = "assemble/select"


def read(run):
    spans = run.trace.span_ms(SPAN)
    if not spans:
        return None
    return sum(spans) / run.trace.requests
