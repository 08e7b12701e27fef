"""% of the profiled second's device-idle time while the batcher thread
is outside ``engine.predict``: in the port's ``serve.first``,
``serve.gather``, ``serve.stack`` or ``serve.reply`` spans."""

from benchmark import program_spans

LOOP = ("serve.first", "serve.gather", "serve.stack", "serve.reply")


def read(ctx):
    spans = program_spans.load(ctx, "serve")
    if spans is None:
        return None
    loop = [s for s in spans.named(*LOOP)
            if s.end > spans.t0 and s.start < spans.t1]
    return spans.idle_share(loop) if loop else None
