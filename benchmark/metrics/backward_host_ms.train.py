"""Median host ms of the training step's backward in the window: the
port's ``step.backward`` span (``total.backward()``; the main thread waits
while autograd's thread enqueues it), summed over a step's
microbatches."""

from benchmark import program_spans


def read(ctx):
    return program_spans.phase_ms(ctx, "step.backward")
