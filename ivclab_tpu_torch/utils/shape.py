"""JPEG zig-zag scan order as index tables (numpy).

Port of the layout helpers of ``ivclab_tpu/utils/shape.py`` that the codec
path needs: the permutation is derived from the anti-diagonal traversal
rule and folded into the DCT matrix rows (``ops/dct.py``) and the
quantization tables (``ops/quant.py``).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def zigzag_scan_positions(n: int = 8) -> tuple[tuple[int, int], ...]:
    """(row, col) positions of an n x n block in JPEG zig-zag scan order.

    Walk anti-diagonals d = r + c from 0 to 2n-2; even diagonals run
    bottom-left -> top-right, odd ones top-right -> bottom-left.
    """
    positions = []
    for d in range(2 * n - 1):
        rng = range(max(0, d - n + 1), min(d, n - 1) + 1)
        rows = list(rng)[::-1] if d % 2 == 0 else list(rng)
        for r in rows:
            positions.append((r, d - r))
    return tuple(positions)


@functools.lru_cache(maxsize=None)
def zigzag_gather_indices(n: int = 8) -> np.ndarray:
    """Flat row-major indices such that ``flat[idx]`` is in scan order."""
    idx = np.asarray([r * n + c for r, c in zigzag_scan_positions(n)], dtype=np.int32)
    idx.setflags(write=False)
    return idx
