"""GOP codec phases, ``FusedVideoCodec.pack_gop``'s map (``fastvideo.py::
_map_gop_hot``: zero-run, ``map_codes_hot``, ``pack_extents``): device ms a
GOP between the CUDA events of the port's span ``ivc.pack.map``."""

from codec_bench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, ("ivc.pack.map",), "device_ms")
