"""Intra codec: host synchronisations a request, the port's counter
``syncs`` (each read of a device value through ``ivc.fetch``)."""

from codec_bench.program_spans import counted


def read(ctx):
    return counted(ctx, ("syncs",))
