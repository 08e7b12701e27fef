"""The inference step's share of the card's peak, in %: the depth
network's forward convolution operations per image (``counts``) times
the images served per second, over the peak of the networks' dtype."""

from benchmark import counts


def read(ctx):
    if ctx.get("kind") != "serve" or ctx.get("peak") is None:
        return None
    flops = counts.depth_forward_flops(vars(ctx["options"]))
    peak = ctx["peak"]["flops_per_s"][ctx["dtype"]]
    return 100.0 * flops * ctx["images_per_s"] / peak
