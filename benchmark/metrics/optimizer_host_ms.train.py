"""Median host ms of the training step's update in the window: the port's
``step.optimizer`` span (the mesh's averaging, the gradients' global norm,
the learning rate and Adam)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.phase_ms(ctx, "step.optimizer")
