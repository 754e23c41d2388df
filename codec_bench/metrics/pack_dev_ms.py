"""GOP codec phases, ``FusedVideoCodec.pack_gop`` (``ops/transform.py``,
``ops/bitpack.py``): device milliseconds a GOP's pack takes, summed over
the operations launched inside the call."""

CALLS = ("cb.pack_gop",)


def read(ctx):
    us = [o["dur_us"] for o in ctx.ops() if o["call"] in CALLS]
    return sum(us) / 1e3 / ctx.n_traced if us else None
