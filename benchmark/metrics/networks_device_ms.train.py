"""Device ms per training step of every kernel that is not one of the
port's own (``counts/kernels``): the networks, the plain ops and Adam,
summed over the profiled steps (concurrent kernels add up)."""

from benchmark import counts


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "train" or trace is None or not trace.kernels:
        return None
    table = counts.kernels()
    us = sum(dur for name, _, dur in trace.kernels
             if counts.port_kernel(name, table) is None)
    return us * 1e-3 / trace.steps
