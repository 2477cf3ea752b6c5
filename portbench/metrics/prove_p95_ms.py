"""prove_p95_ms: the 95th percentile, over every request of the window, of
one request's ms on the host clock, from the blob handed over until its
Proof object is back (inclusive quantiles, as `statistics.quantiles`)."""

import statistics


def read(run):
    ms = [r.ms for r in run.requests]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
