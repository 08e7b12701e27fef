"""Median host ms of the benchmark's span around each call of the
training step in the window. The step does not synchronise, so this is
the time the host takes to enqueue it (it waits only when the device's
queue or the allocator is full)."""


def read(ctx):
    if ctx.get("kind") != "train" or ctx["step_host_median_s"] is None:
        return None
    return ctx["step_host_median_s"] * 1e3
