"""Kernel ``csrc/decode_walk.cu::walk_kernel`` (the hot/escape walk): the
least time of its launches on the H100
(``codec_bench/roofline.py::decode_walk_bound`` of the bits each block
walks, from the reference's own walk or coding of the same GOP) over their
device time, in per cent. Launches pair with a GOP's walks in order: the
motion walk, then the residual walk, of a container decode; the residual
walk alone of ``decode_gop``."""

from codec_bench import roofline

KERNEL = "walk_kernel"


def read(ctx):
    launches = ctx.launches(KERNEL)
    if not launches:
        return None
    bound_ms = 0.0
    for gop, k, _ in launches:
        w = ctx.walk(gop, "hot", k)
        if w is None:
            return None
        bound_ms += roofline.decode_walk_bound(w["block_bits"], w["LW"], w["max_syms"])[0]
    return 100.0 * bound_ms / (sum(us for *_, us in launches) / 1e3)
