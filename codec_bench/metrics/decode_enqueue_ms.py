"""Adaptive video codec, ``decode_from_container``'s enqueue: host ms a
GOP in the port's span ``ivc.decode.enqueue`` (the walks, zero-run decode,
IDCT and the motion-compensation loop)."""

from codec_bench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, ("ivc.decode.enqueue",))
