"""JPEG Annex-K quantization tables in zig-zag scan order (numpy).

Port of the tables of ``ivclab_tpu/ops/quant.py``. Quantization itself is
fused into the codec's transform step: ``round(c * (1 / t))`` (round half
to even) and dequantization ``int(s * t)`` (truncation toward zero), as
``torch.round`` and ``.to(torch.int32)`` compute them.
"""

from __future__ import annotations

import numpy as np

from ivclab_tpu_torch.utils.shape import zigzag_gather_indices

# ITU-T T.81 (JPEG) Annex K.1 example quantization tables.
JPEG_LUMINANCE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 55, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)

# The course reference deviates from Annex K at [2,1] (13 instead of 26);
# matched for parity with the JAX package.
JPEG_CHROMINANCE = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 13, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float32,
)


def quant_tables(num_channels: int = 3) -> np.ndarray:
    """``[C, 8, 8]`` stack: luminance for channel 0, chrominance for the rest."""
    return np.stack([JPEG_LUMINANCE] + [JPEG_CHROMINANCE] * (num_channels - 1), axis=0)


def quant_table_zigzag(scale: float, num_channels: int = 3) -> np.ndarray:
    """Scan-ordered flat tables ``[C, 64]`` scaled by ``scale``."""
    tables = quant_tables(num_channels) * np.float32(scale)
    flat = tables.reshape(num_channels, 64)
    return np.ascontiguousarray(flat[:, zigzag_gather_indices(8)])
