"""Intra codec, ``IntraCodec.encode_to_container``: host ms a request in
the port's span ``ivc.intra.encode`` (symbolize, pack with its two reads,
serialize with its three)."""

from codec_bench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, ("ivc.intra.encode",))
