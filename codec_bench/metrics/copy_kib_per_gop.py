"""Codec entry, host side: KiB a GOP copied between the host and the card,
the port's counters ``h2d_bytes`` and ``d2h_bytes``."""

from codec_bench.program_spans import counted


def read(ctx):
    n = counted(ctx, ("h2d_bytes", "d2h_bytes"))
    return None if n is None else n / 1024
