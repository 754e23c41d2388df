"""Codec entry, host side (``models/fastvideo.py``, ``models/videocodec.py``):
host milliseconds a GOP spends inside the port's calls, unsynchronised
(the benchmark's spans around each call), averaged over the GOPs of the
window that the profiler did not see."""


def read(ctx):
    if not ctx.host_ms:
        return None
    return sum(sum(g.values()) for g in ctx.host_ms) / len(ctx.host_ms)
