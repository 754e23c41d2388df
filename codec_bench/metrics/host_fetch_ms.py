"""Adaptive video codec: host ms a GOP inside the port's ``ivc.fetch``
spans, where the host reads a device value (or copies from pageable
memory): the wait for the card plus the copy."""

from codec_bench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, ("ivc.fetch",))
