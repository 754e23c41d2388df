"""Kernel ``csrc/decode_walk.cu::canon_walk_kernel`` in the intra cell: the
one canonical walk of every block of an image a request's decode launches
(``codec_bench/roofline.py::canon_walk_bound`` of the bits each block walks
in the container, from the judge's own walk) over its device time, in per
cent; the reading of ``canon_walk_roofline_pct.py``."""

from codec_bench.metrics.canon_walk_roofline_pct import read  # noqa: F401
