"""The device's idle share over the window, in %: 1 - the device's busy
time per step (the union of kernel, copy and set intervals in the
profiled steps' trace) over the window's wall time per step. The
profiler slows the host, so the profiled steps' own idle share would
read its instrumentation's cost as idle device time."""


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "train" or trace is None or not ctx.get("steps"):
        return None
    busy_per_step = trace.busy_s / trace.steps
    return 100.0 * (1.0 - busy_per_step * ctx["steps"] / ctx["window_s"])
