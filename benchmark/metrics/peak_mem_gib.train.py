"""GiB of device memory at the allocator's peak during the window
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its
start)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["peak_window_bytes"]:
        return None
    return ctx["peak_window_bytes"] / 2 ** 30
