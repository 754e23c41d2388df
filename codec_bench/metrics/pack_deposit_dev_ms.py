"""GOP codec phases, ``FusedVideoCodec.pack_gop``'s deposit (``ops/
transform.py::pack_grouped_sized``: prefix sums, ``scatter_add_``): device
ms a GOP between the CUDA events of the port's span ``ivc.pack.deposit``."""

from codec_bench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, ("ivc.pack.deposit",), "device_ms")
