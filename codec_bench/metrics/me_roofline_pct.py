"""Kernel ``csrc/motion_search.cu::me_kernel``: the least time of its
launches on the H100 (``codec_bench/roofline.py::motion_search_bound`` of
one whole-frame search at the configuration's size and search range, each
launch) over their device time, in per cent."""

from codec_bench import roofline

KERNEL = "me_kernel"


def read(ctx):
    launches = ctx.launches(KERNEL)
    if not launches:
        return None
    H, W, sr = ctx.cfg["H"], ctx.cfg["W"], ctx.cfg["sr"]
    bound_ms = roofline.motion_search_bound(H, H, W, sr)[0] * len(launches)
    return 100.0 * bound_ms / (sum(us for *_, us in launches) / 1e3)
