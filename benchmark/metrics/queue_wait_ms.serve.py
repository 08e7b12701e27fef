"""Median ms a request waited in ``MicroBatcher``'s queue in the window:
the port's ``serve.queue`` span, from ``submit`` to the batcher taking
it."""

import statistics

from benchmark import program_spans


def read(ctx):
    queued = program_spans.serve_requests(ctx)
    if queued is None:
        return None
    return statistics.median(s.seconds for s in queued) * 1e3
