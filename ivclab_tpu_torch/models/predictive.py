"""Predictive (DPCM) image coding facades.

Port of ``ivclab_tpu/models/predictive.py`` (the course reference's
single_pixel_predictor, three_pixels_predictor and the ch2 LOCO-I
min_entropy_predictor) on top of the wavefront in ``ops/predictive.py``.
Each takes a device; results are tensors on it.

As in the JAX package, single_pixel_predictor returns every channel with
the first column copied (the reference's loop returns only the last
channel, against its own docstring).
"""

from __future__ import annotations

import torch

from ivclab_tpu_torch.ops.color import _f32, rgb2ycbcr
from ivclab_tpu_torch.ops.predictive import predict_from_neighbors
from ivclab_tpu_torch.ops.resample import _decimate_iir
from ivclab_tpu_torch.utils.shape import as_tensor

COEFFS_Y = (7 / 8, -4 / 8, 5 / 8)
COEFFS_CBCR = (3 / 8, -2 / 8, 7 / 8)


def single_pixel_predictor(image, device: str | torch.device = "cuda") -> torch.Tensor:
    """Residual of the left-neighbour predictor ``R - L``; the first column
    (no left neighbour) is copied. Rounded and clipped to [-255, 255]."""
    x = _f32(image).to(device)
    residual = torch.cat([x[:, :1], x[:, 1:] - x[:, :-1]], dim=1)
    return torch.round(residual.clamp(-255, 255))


def min_entropy_predictor(image, device: str | torch.device = "cuda"):
    """Open-loop LOCO-I (median edge-detecting) predictor residuals, in
    int32. With N, W, NW the original neighbours:

      pred = min(N, W)      if NW >= max(N, W)
             max(N, W)      if NW <= min(N, W)
             N + W - NW     otherwise

    The first row predicts from W, the first column from N, pixel (0, 0)
    from 128. Returns ``(residuals [H*W] int32 row-major, predicted [H, W]
    int32)``.
    """
    x = as_tensor(image).to(device=device, dtype=torch.int32)
    if x.ndim == 3 and x.shape[2] == 1:  # [H, W, 1] grayscale
        x = x[:, :, 0]
    H, W = x.shape
    zrow = torch.zeros((1, W), dtype=torch.int32, device=x.device)
    zcol = torch.zeros((H, 1), dtype=torch.int32, device=x.device)
    N = torch.cat([zrow, x[:-1]], dim=0)
    Wn = torch.cat([zcol, x[:, :-1]], dim=1)
    NW = torch.cat([zcol, N[:, :-1]], dim=1)
    mx = torch.maximum(N, Wn)
    mn = torch.minimum(N, Wn)
    pred = torch.where(NW >= mx, mn, torch.where(NW <= mn, mx, N + Wn - NW))
    pred[0, :] = Wn[0, :]  # first row: left neighbour
    pred[:, 0] = N[:, 0]   # first column: upper neighbour
    pred[0, 0] = 128
    return (x - pred).reshape(-1), pred


def _residual_int(res: torch.Tensor) -> torch.Tensor:
    return torch.round(res.clamp(-255, 255)).to(torch.int32)


def three_pixels_predictor(image, subsample_color_channels: bool = False,
                           device: str | torch.device = "cuda"):
    """Closed-loop 3-neighbour DPCM residuals for Y and CbCr.

    Y coefficients (7/8, -4/8, 5/8), CbCr (3/8, -2/8, 7/8); optional
    chroma decimation by 2 (the order-8 Chebyshev-I IIR, zero phase:
    scipy.signal.decimate's default, which the course reference uses).
    Returns int32 residuals clipped to [-255, 255]: ``[H, W]`` and
    ``[H', W', 2]``.
    """
    x = _f32(image).to(device)
    ycbcr = rgb2ycbcr(x)
    Y = ycbcr[:, :, 0:1]
    CbCr = ycbcr[:, :, 1:3]
    residual_Y = predict_from_neighbors(Y, COEFFS_Y)
    if subsample_color_channels:
        CbCr = _decimate_iir(_decimate_iir(CbCr, 0), 1)
    residual_CbCr = predict_from_neighbors(CbCr, COEFFS_CBCR)
    return _residual_int(residual_Y), _residual_int(residual_CbCr)
