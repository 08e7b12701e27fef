"""Median ms, over the window's engine calls, of the batcher thread's time
from one ``engine.predict`` span ending to the next one starting (the
replies, the wait for a first request, the gathering and the stacking:
the device has no batch of this stream then)."""

import statistics

from benchmark import program_spans


def read(ctx):
    found = program_spans.serve_calls(ctx)
    if found is None:
        return None
    _, calls = found
    return statistics.median(b.start - a.end for a, b in
                             zip(calls, calls[1:])) * 1e-6
