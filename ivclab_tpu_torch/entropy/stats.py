"""Symbol histograms for Huffman training.

Port of ``ivclab_tpu/entropy/stats.py::histogram_int32``.
"""

from __future__ import annotations

import torch


def histogram_int32(values: torch.Tensor, lo: int, hi: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Histogram of int symbols over ``[lo, hi)`` as ``[hi - lo]`` int32.

    ``mask`` marks the valid entries (padded symbol buffers); out-of-range
    symbols are dropped.
    """
    v = values.reshape(-1).to(torch.int64)
    valid = (v >= lo) & (v < hi)
    if mask is not None:
        valid = valid & mask.reshape(-1).to(torch.bool)
    return torch.bincount(v[valid] - lo, minlength=hi - lo).to(torch.int32)
