"""Adaptive video codec, ``VideoCodec.encode_to_container``: wall
milliseconds a call takes on the host clock (the call fetches the frames'
statistics and the packed words, so it returns with its device work done),
averaged over the GOPs the profiler did not see."""

CALL = "cb.encode_to_container"


def read(ctx):
    ms = [g[CALL] for g in ctx.host_ms if CALL in g]
    return sum(ms) / len(ms) if ms else None
