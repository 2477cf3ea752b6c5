"""ingest_copy_p95_ms.prove: the 95th percentile of the host ms of the
program's spans `ingest/copy` in the traced window (inclusive quantiles,
as `prove_p95_ms`)."""

import statistics

SPAN = "ingest/copy"


def read(run):
    spans = run.trace.span_ms(SPAN)
    if len(spans) < 2:
        return None
    return statistics.quantiles(spans, n=20, method="inclusive")[18]
