"""Median host ms, over the window's engine calls, of the engine's
``engine.h2d`` (the batch from numpy to the device and its float cast)
and ``engine.forward`` (the depth network's enqueue) spans: the call
without the copy back, where the host waits on the device."""

import statistics

from benchmark import program_spans


def read(ctx):
    found = program_spans.serve_calls(ctx)
    if found is None:
        return None
    spans, calls = found
    return statistics.median(program_spans.children_seconds(
        spans, calls[1:], "engine.h2d", "engine.forward")) * 1e3
