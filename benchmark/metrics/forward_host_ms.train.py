"""Median host ms of the training step's forward enqueue in the window:
the port's ``step.forward`` span (augment, depth, pose, warp and loss),
summed over a step's microbatches."""

from benchmark import program_spans


def read(ctx):
    return program_spans.phase_ms(ctx, "step.forward")
