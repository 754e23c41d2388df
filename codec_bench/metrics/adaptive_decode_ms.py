"""Adaptive video codec, ``VideoCodec.decode_from_container(...,
return_device=True)``: host milliseconds until the call returns (its parse,
uploads and enqueue; it makes no host synchronisation), averaged over the
GOPs the profiler did not see."""

CALL = "cb.decode_from_container"


def read(ctx):
    if ctx.cfg["codec"] != "VideoCodec":
        return None
    ms = [g[CALL] for g in ctx.host_ms if CALL in g]
    return sum(ms) / len(ms) if ms else None
