"""Per-coefficient block quantization with JPEG Annex-K tables.

Port of ``ivclab_tpu/ops/quant.py``. The codec fuses quantization into its
transform step with the scan-ordered flat tables (:func:`quant_table_zigzag`):
``round(c * (1 / t))`` (round half to even) and dequantization
``int(s * t)`` (truncation toward zero), as ``torch.round`` and
``.to(torch.int32)`` compute them. :class:`PatchQuant` is the course
reference's facade over ``[H_patch, W_patch, C, 8, 8]`` blocks; it divides
by the table, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ivclab_tpu_torch.utils.shape import as_tensor, zigzag_gather_indices

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


def quant_tables(num_channels: int = 3, luminance=None, chrominance=None) -> np.ndarray:
    """``[C, 8, 8]`` stack: luminance for channel 0, chrominance for the rest."""
    lum = np.asarray(JPEG_LUMINANCE if luminance is None else luminance, dtype=np.float32)
    chrom = np.asarray(JPEG_CHROMINANCE if chrominance is None else chrominance, dtype=np.float32)
    return np.stack([lum] + [chrom] * (num_channels - 1), axis=0)


def quant_table_zigzag(scale: float, num_channels: int = 3, luminance=None,
                       chrominance=None) -> np.ndarray:
    """Scan-ordered flat tables ``[C, 64]`` scaled by ``scale``."""
    tables = quant_tables(num_channels, luminance, chrominance) * np.float32(scale)
    flat = tables.reshape(num_channels, 64)
    return np.ascontiguousarray(flat[:, zigzag_gather_indices(8)])


def quantize_flat(coeffs, table_flat) -> torch.Tensor:
    """``round(c * (1 / t))`` -> int32 over ``[..., C, 64]`` scan-ordered
    coefficients (the reciprocal taken in float32 on the host)."""
    c = as_tensor(coeffs).to(torch.float32)
    inv = torch.from_numpy(1.0 / np.asarray(table_flat, dtype=np.float32)).to(c.device)
    return torch.round(c * inv).to(torch.int32)


def dequantize_flat(symbols, table_flat) -> torch.Tensor:
    """``int(s * t)`` (truncation toward zero) over ``[..., C, 64]``."""
    s = as_tensor(symbols).to(torch.float32)
    t = torch.from_numpy(np.asarray(table_flat, dtype=np.float32)).to(s.device)
    return (s * t).to(torch.int32)


class PatchQuant:
    """The course reference's quantizer facade over ``[H_patch, W_patch, C,
    8, 8]`` block tensors."""

    def __init__(self, quantization_scale: float = 1.0, luminance=None, chrominance=None):
        self.quantization_scale = float(quantization_scale)
        self.luminance = np.asarray(JPEG_LUMINANCE if luminance is None else luminance,
                                    dtype=np.float32)
        self.chrominance = np.asarray(JPEG_CHROMINANCE if chrominance is None else chrominance,
                                      dtype=np.float32)

    def get_quantization_table(self) -> np.ndarray:
        table = np.stack([self.luminance, self.chrominance, self.chrominance], axis=0)
        return table * self.quantization_scale

    def _table(self, x: torch.Tensor) -> torch.Tensor:
        table = np.asarray(self.get_quantization_table(), dtype=np.float32)
        return torch.from_numpy(table).to(x.device)[None, None, : x.shape[2]]

    def quantize(self, patched_img) -> torch.Tensor:
        x = as_tensor(patched_img).to(torch.float32)
        return torch.round(x / self._table(x)).to(torch.int32)

    def dequantize(self, quantized_img) -> torch.Tensor:
        x = as_tensor(quantized_img).to(torch.float32)
        return (x * self._table(x)).to(torch.int32)
