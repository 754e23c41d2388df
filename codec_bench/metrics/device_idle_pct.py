"""Device (H100): the share of the traced slice in which no kernel, copy or
fill ran on the card, from the profiler's device events."""

from codec_bench import trace


def read(ctx):
    if not ctx.slice:
        return None
    a, b = ctx.slice["window"]
    busy = sum(hi - lo for lo, hi in trace.busy_intervals(ctx.slice["ops"], ctx.slice["window"]))
    return 100.0 * (1.0 - busy / (b - a)) if b > a else None
