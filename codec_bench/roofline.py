"""The benchmark's frozen roofline arithmetic: a kernel's least time on the
H100, from the operations and bytes its inputs need.

Copied from ``ivclab_tpu_torch/utils/timing.py`` (``motion_search_bound``,
``decode_walk_bound``, ``canon_walk_bound`` and the peaks) so that a later
change to the program cannot change the yardstick; ``tests`` holds this copy
equal to that one on fixed inputs.
"""

from __future__ import annotations

import numpy as np

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA's data
# sheet): FP32 on the CUDA cores, an FMA counted as two operations; HBM3.
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def motion_search_bound(ref_rows: int, H: int, W: int, sr: int) -> tuple[float, str]:
    """(least ms, "operations" or "bytes") for one full search of an
    ``[H, W]`` current plane against a ``[ref_rows, W]`` reference: every
    block's (2 sr + 1)^2 candidates at 64 subtract, multiply and add triples
    each, against each input read once and the int32 indices written once."""
    blocks = (H // 8) * (W // 8)
    ops = blocks * (2 * sr + 1) ** 2 * 64 * 3
    nbytes = (ref_rows + H) * W * 4 + blocks * 4
    op_ms = ops / H100_FP32_FLOPS * 1e3
    byte_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def decode_walk_bound(block_bits, LW: int, max_syms: int) -> tuple[float, str]:
    """(least ms, "bytes") for one hot/escape decode walk: of each block's
    row of ``LW`` int64 words (rows from a 32-byte boundary), the 32-byte
    sectors of the ``ceil(bits / 32)`` words its bits lie in; each block's
    int32 count read once and its ``max_syms`` int32 outputs written once."""
    bits = np.asarray(block_bits, dtype=np.int64).reshape(-1)
    words = np.minimum((bits + 31) // 32, LW)
    start = np.arange(bits.size, dtype=np.int64) * (LW * 8)
    sectors = np.where(words > 0, (start + words * 8 + 31) // 32 - start // 32, 0)
    nbytes = int(sectors.sum()) * 32 + bits.size * (4 + max_syms * 4)
    return nbytes / H100_HBM_BYTES_PER_S * 1e3, "bytes"


def canon_walk_bound(block_offsets, block_bits, n_words: int, max_syms: int
                     ) -> tuple[float, str]:
    """(least ms, "bytes") for one canonical decode walk of an ``n_words``
    int64 word stream: the 32-byte sectors of the words the blocks' bits lie
    in, each once however many blocks share it; each block's int32 offset
    and count read once and its ``max_syms`` int32 outputs written once."""
    offs = np.asarray(block_offsets, dtype=np.int64).reshape(-1)
    bits = np.asarray(block_bits, dtype=np.int64).reshape(-1)
    walked = bits > 0
    first = np.clip(offs[walked] >> 5, 0, n_words - 1) // 4
    last = np.clip((offs[walked] + bits[walked] - 1) >> 5, 0, n_words - 1) // 4
    n_sectors = -(-n_words // 4)
    edge = np.zeros(n_sectors + 1, dtype=np.int64)
    np.add.at(edge, first, 1)
    np.add.at(edge, last + 1, -1)
    sectors = int((np.cumsum(edge[:-1]) > 0).sum())
    nbytes = sectors * 32 + offs.size * (8 + max_syms * 4)
    return nbytes / H100_HBM_BYTES_PER_S * 1e3, "bytes"


def row_words(block_bits) -> int:
    """A hot walk's row width: the words of its longest block plus the two
    of look-ahead, rounded up to a 32-byte sector (4 int64 words), so every
    row starts on a sector as the walk's rows do."""
    bits = np.asarray(block_bits, dtype=np.int64)
    need = int((bits.max(initial=0) + 31) // 32) + 2
    return -(-need // 4) * 4


# Output widths the walks write per block: the smallest bucket holding the
# largest block's count (the fixed-codebook decode's, and the canonical
# walk's slices of its 128-symbol capacity).
HOT_CAPS = (32, 64, 128)
CANON_CAPS = (32, 48, 64, 96, 128)


def out_width(max_count: int, buckets) -> int:
    for b in buckets:
        if b >= max_count:
            return b
    return buckets[-1]
