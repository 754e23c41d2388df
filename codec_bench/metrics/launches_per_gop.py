"""Codec entry, enqueue: device kernels, copies and fills a GOP launches,
from the profiler's device events of the fully traced GOPs."""


def read(ctx):
    ops = ctx.ops()
    return len(ops) / ctx.n_traced if ops else None
