"""Requests served per engine call in the window (completed requests
over ``InferenceEngine.calls``)."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["engine_calls"]:
        return None
    return ctx["completed"] / ctx["engine_calls"]
