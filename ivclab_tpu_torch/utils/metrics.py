"""Distortion and rate metrics (MSE, PSNR, bpp).

Port of ``ivclab_tpu/utils/metrics.py``. Images are numpy arrays or
tensors; a pair is compared on the reconstruction's device when it is a
tensor (the CPU otherwise). The mean is a float32 reduction, so its last
bits depend on the device's summation order.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device or "cpu")


def _coerce_pair(orig, rec):
    dev = rec.device if isinstance(rec, torch.Tensor) else (
        orig.device if isinstance(orig, torch.Tensor) else None)
    orig, rec = _t(orig, dev), _t(rec, dev)
    # gray <-> RGB coercion, as the reference does
    if orig.ndim == 2 and rec.ndim == 3:
        orig = torch.stack([orig] * rec.shape[-1], dim=-1)
    elif orig.ndim == 3 and rec.ndim == 2:
        rec = torch.stack([rec] * orig.shape[-1], dim=-1)
    if orig.shape != rec.shape:
        raise ValueError(f"Image shapes don't match: {tuple(orig.shape)} vs {tuple(rec.shape)}")
    return orig, rec


def calc_mse(orig, rec) -> torch.Tensor:
    """Mean squared error over all pixels (a float32 scalar tensor)."""
    orig, rec = _coerce_pair(orig, rec)
    diff = orig.to(torch.float32) - rec.to(torch.float32)
    return (diff * diff).mean()


def calc_psnr(orig, rec, maxval: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio, assuming [0, maxval] signals:
    ``20 * log10(maxval / sqrt(mse))``."""
    return 20.0 * torch.log10(maxval / torch.sqrt(calc_mse(orig, rec)))


def calc_bpp(bitsize, shape, per_channel_group: bool = False) -> float:
    """Bits per pixel with the reference's two conventions: images
    ``bits / (H*W)``; video ``bits / (size/3)``."""
    shape = tuple(int(s) for s in shape)
    if per_channel_group:
        denom = int(np.prod(shape)) / 3
    else:
        denom = shape[0] * shape[1]
    return float(bitsize) / denom
