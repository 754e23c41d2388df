"""Adaptive video codec, ``decode_from_container``'s preparation: host ms
a GOP in the port's spans ``ivc.decode.parse`` (the container's bytes),
``ivc.decode.tables`` (canonical codes, decode tables, the quantiser's
table) and ``ivc.decode.upload`` (the sections' device views)."""

from codec_bench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, ("ivc.decode.parse", "ivc.decode.tables", "ivc.decode.upload"))
