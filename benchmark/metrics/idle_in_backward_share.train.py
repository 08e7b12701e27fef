"""% of the profiled steps' device-idle time while the main thread is in
the port's ``step.backward`` span (the idle intervals of the sub-window's
trace overlapped with the span's)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.train_idle_share(ctx, "step.backward")
