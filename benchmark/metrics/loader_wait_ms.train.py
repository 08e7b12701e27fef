"""Host ms the training step waited on the Loader's queue per batch in
the window (``Loader.wait_seconds`` / ``Loader.batches``)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["loader_batches"]:
        return None
    return ctx["loader_wait_s"] * 1e3 / ctx["loader_batches"]
