"""Adaptive video codec, ``VideoCodec.encode_to_container``'s host
codebook builds (``_train_codes``, ``limit_code_lengths`` inside): host ms
a GOP in the port's span ``ivc.adaptive.codebooks``."""

from codec_bench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, ("ivc.adaptive.codebooks",))
