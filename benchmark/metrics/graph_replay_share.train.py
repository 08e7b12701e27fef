"""% of the window's training steps that the port replayed from its CUDA
graph: the ``step`` spans holding a ``step.replay`` (``train/step.py``),
over the window's steps, chosen as ``program_spans.train_phases`` chooses
them. Nothing where the program records no spans."""

from benchmark import program_spans


def read(ctx):
    spans = program_spans.load(ctx, "train")
    if spans is None or not ctx.get("steps"):
        return None
    steps = sorted((s for s in spans.named("step") if s.start < spans.t0),
                   key=lambda s: s.start)[-ctx["steps"]:]
    if len(steps) < ctx["steps"] or not spans.covers(steps[0].start):
        return None
    replayed = {s.parent for s in spans.named("step.replay")}
    return 100.0 * sum(s.id in replayed for s in steps) / len(steps)
