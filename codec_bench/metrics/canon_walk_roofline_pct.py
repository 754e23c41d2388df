"""Kernel ``csrc/decode_walk.cu::canon_walk_kernel`` (the canonical walk):
the least time of its launches on the H100
(``codec_bench/roofline.py::canon_walk_bound`` of the bits each block walks
in its container section, from the reference's own walk) over their device
time, in per cent. A GOP's launches pair with its walks in order: the
motion section, then each frame's residual section."""

from codec_bench import roofline

KERNEL = "canon_walk_kernel"


def read(ctx):
    launches = ctx.launches(KERNEL)
    if not launches:
        return None
    bound_ms = 0.0
    for gop, k, _ in launches:
        w = ctx.walk(gop, "canon", k)
        if w is None:
            return None
        bound_ms += roofline.canon_walk_bound(w["offsets"], w["block_bits"], w["n_words"],
                                              w["max_syms"])[0]
    return 100.0 * bound_ms / (sum(us for *_, us in launches) / 1e3)
