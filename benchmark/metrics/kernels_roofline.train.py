"""The port's kernels' share of their roofline in the training step, in
%: the least time of every launch of a port kernel in the profiled steps
(bytes at the memory rate or float operations at the float32 rate,
``counts``) over the device time those launches took. Nothing when no
port kernel ran."""

from benchmark import counts


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "train" or trace is None or ctx.get("peak") is None:
        return None
    table = counts.kernels()
    least = measured = 0.0
    for name, _, dur in trace.kernels:
        entry = counts.port_kernel(name, table)
        if entry is None:
            continue
        least += counts.least_seconds(entry, ctx["pixels"], ctx["peak"])[0]
        measured += dur * 1e-6
    return 100.0 * least / measured if measured else None
