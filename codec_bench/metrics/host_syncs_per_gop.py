"""Codec entry, host side: host synchronisations a GOP, the port's counter
``syncs`` (each read of a device value and each copy from pageable memory
to the card)."""

from codec_bench.program_spans import counted


def read(ctx):
    return counted(ctx, ("syncs",))
