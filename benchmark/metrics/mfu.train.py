"""The training step's share of the card's peak, in %: the convolution
operations of a step's forward and backward passes (``counts``, from the
configuration's shapes) times the steps of the window, over the window's
seconds and the peak of the networks' dtype."""

from benchmark import counts


def read(ctx):
    if ctx.get("kind") != "train" or ctx.get("peak") is None:
        return None
    flops = counts.train_step_flops(vars(ctx["options"])) * ctx["steps"]
    peak = ctx["peak"]["flops_per_s"][ctx["dtype"]]
    return 100.0 * flops / ctx["window_s"] / peak
