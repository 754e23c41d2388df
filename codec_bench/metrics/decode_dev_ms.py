"""GOP codec phases, ``FusedVideoCodec.decode_gop`` or
``decode_from_container``: device milliseconds a GOP's decode takes,
summed over the operations launched inside the call."""

CALLS = ("cb.decode_gop", "cb.decode_from_container")


def read(ctx):
    if ctx.cfg["codec"] != "FusedVideoCodec":
        return None
    us = [o["dur_us"] for o in ctx.ops() if o["call"] in CALLS]
    return sum(us) / 1e3 / ctx.n_traced if us else None
