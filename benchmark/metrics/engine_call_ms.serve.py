"""Median host ms of ``InferenceEngine.predict`` in the window, from the
benchmark's span around the engine instance's method (the copy in, the
depth network, the copy of the disparities out)."""


def read(ctx):
    if ctx.get("kind") != "serve" or ctx["engine_call_median_s"] is None:
        return None
    return ctx["engine_call_median_s"] * 1e3
