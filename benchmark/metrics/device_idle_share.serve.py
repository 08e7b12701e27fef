"""The device's idle share over the window, in %: 1 - the device's busy
time per request (the union of kernel, copy and set intervals in the
profiled sub-window over the requests completed in it) times the
window's requests per second. The profiler slows the host, so the
sub-window's own idle share would read its instrumentation's cost as
idle device time."""


def read(ctx):
    trace = ctx.get("trace")
    if (ctx.get("kind") != "serve" or trace is None
            or not ctx.get("trace_completed")):
        return None
    busy_per_request = trace.busy_s / ctx["trace_completed"]
    return 100.0 * (1.0 - busy_per_request * ctx["images_per_s"])
