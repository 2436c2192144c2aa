"""The 90th percentile of the intervals between the training loop's
successive batch requests in the window (host clock), in ms."""

import statistics


def read(ctx):
    stamps = ctx.get("stamps") or []
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    if len(gaps) < 10:
        return None
    return 1e3 * statistics.quantiles(gaps, n=10)[-1]
