"""Utilities: image I/O, metrics, layout helpers and fixtures."""

from ivclab_tpu_torch.utils.io import imread, imwrite, imshow
from ivclab_tpu_torch.utils.metrics import calc_mse, calc_psnr, calc_bpp
from ivclab_tpu_torch.utils.shape import (
    ZigZag,
    Patcher,
    pad_to_block_multiple,
    zigzag_gather_indices,
    zigzag_scatter_indices,
    zigzag_scan_positions,
)
from ivclab_tpu_torch.utils import fixtures

__all__ = [
    "imread", "imwrite", "imshow",
    "calc_mse", "calc_psnr", "calc_bpp",
    "ZigZag", "Patcher", "pad_to_block_multiple",
    "zigzag_gather_indices", "zigzag_scatter_indices", "zigzag_scan_positions",
    "fixtures",
]
