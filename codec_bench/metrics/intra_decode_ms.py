"""Intra codec, ``IntraCodec.decode_from_container(...,
return_device=True)``: host ms a request in the port's span
``ivc.intra.decode`` (parse, tables, upload, enqueue; no host read)."""

from codec_bench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, ("ivc.intra.decode",))
