"""Closed-loop DPCM prediction as an anti-diagonal wavefront.

Port of ``ivclab_tpu/ops/predictive.py``. Every pixel depends on its left,
top and top-left reconstructed neighbours, which lie on the two previous
anti-diagonals, so the loop runs over the H+W-3 diagonals of the interior
and updates a whole diagonal, every channel at once, per step.

The pixels are kept in diagonal-major order (each diagonal's pixels by
row), computed once per frame size: a diagonal's interior and its three
neighbour runs are then contiguous slices, so a step gathers nothing. A
step is six tensor operations (eight when ``quant_step`` is not 1):

    pred = fma(c, T, fma(a, L, b*TL))
    err  = round((x - pred) / q)
    rec  = pred + err*q

with ``b*TL``, the division, ``err*q`` and the last sum rounded to
float32 on their own. This is XLA:CPU's arithmetic for the JAX package's
loop body, and with it the residuals and reconstructions equal the JAX
package's bit for bit. Each FMA is computed in float64, where the product
of two float32 values is exact, and rounded to float32 once, so the card
and the CPU agree too. The division is by a one-element tensor on the
plane's device: PyTorch divides a CUDA tensor by a Python scalar as a
multiplication by its reciprocal, which rounds differently.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ivclab_tpu_torch.ops.color import _f32


@functools.lru_cache(maxsize=8)
def _diagonals(H: int, W: int):
    """(perm, steps) of an H x W frame: ``perm[k]`` is the raster index of
    the k-th pixel in diagonal-major order; ``steps`` holds, for each
    diagonal d = 2 .. H+W-2 with interior pixels, the diagonal-major start
    of its interior run and of its left, top and top-left neighbour runs,
    and the run's length."""
    d = np.arange(H + W - 1)
    ilo = np.maximum(0, d - W + 1)
    ihi = np.minimum(d, H - 1)
    off = np.concatenate([[0], np.cumsum(ihi - ilo + 1)])
    perm = np.concatenate([np.arange(lo, hi + 1) * (W - 1) + dd
                           for dd, lo, hi in zip(d, ilo, ihi)]).astype(np.int64)
    steps = []
    for dd in range(2, H + W - 1):
        a, b = max(1, dd - W + 1), min(dd - 1, H - 1)
        if b < a:
            continue
        steps.append((int(off[dd] + a - ilo[dd]), int(off[dd - 1] + a - ilo[dd - 1]),
                      int(off[dd - 1] + a - 1 - ilo[dd - 1]),
                      int(off[dd - 2] + a - 1 - ilo[dd - 2]), int(b - a + 1)))
    return torch.from_numpy(perm), tuple(steps)


class _Wavefront:
    """One frame size's diagonal order and the coefficients, on a device."""

    def __init__(self, shape, coefficients, quant_step, device):
        H, W, self.C = shape
        perm, self.steps = _diagonals(H, W)
        self.perm = perm.to(device)
        a, b, c = (float(np.float32(v)) for v in coefficients)
        self.b = b
        self.a = torch.tensor([a], dtype=torch.float64, device=device)
        self.c = torch.tensor([c], dtype=torch.float64, device=device)
        self.q = float(np.float32(quant_step))
        self.q_t = torch.tensor([self.q], dtype=torch.float32, device=device)
        n = max((s[-1] for s in self.steps), default=0)
        self.tmp = torch.empty((3, n, self.C), dtype=torch.float32, device=device)
        self.shape = shape

    def to_diagonals(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(-1, self.C).index_select(0, self.perm)

    def to_raster(self, xd: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(xd)
        out.index_copy_(0, self.perm, xd)
        return out.reshape(self.shape)

    def predict(self, rec: torch.Tensor, step) -> tuple[torch.Tensor, torch.Tensor]:
        """(pred, a scratch run) of one diagonal from ``rec``'s neighbour runs."""
        _, sl, st, stl, n = step
        p, inner, pred = self.tmp[0, :n], self.tmp[1, :n], self.tmp[2, :n]
        torch.mul(rec[stl:stl + n], self.b, out=p)
        torch.addcmul(p, rec[sl:sl + n], self.a, out=inner)
        torch.addcmul(inner, rec[st:st + n], self.c, out=pred)
        return pred, p


def _wavefront_dpcm(x: torch.Tensor, coefficients, quant_step: float):
    """Forward closed-loop DPCM over ``[H, W, C]`` float32. The first row
    and column are copied verbatim (residual 0). Returns (residual, recon)."""
    wf = _Wavefront(tuple(x.shape), coefficients, quant_step, x.device)
    xd = wf.to_diagonals(x)
    rec = xd.clone()  # borders verbatim; every interior pixel is overwritten
    res = torch.zeros_like(xd)
    for step in wf.steps:
        s, n = step[0], step[-1]
        pred, err = wf.predict(rec, step)
        torch.sub(xd[s:s + n], pred, out=err)
        if wf.q != 1.0:
            err.div_(wf.q_t)
        torch.round(err, out=res[s:s + n])
        if wf.q != 1.0:
            torch.mul(res[s:s + n], wf.q, out=err)
            torch.add(pred, err, out=rec[s:s + n])
        else:
            torch.add(pred, res[s:s + n], out=rec[s:s + n])
    return wf.to_raster(res), wf.to_raster(rec)


def predict_from_neighbors(original, coefficients, quant_step: float = 1.0,
                           return_recon: bool = False):
    """Wavefront closed-loop DPCM residuals (and the reconstruction).

    ``original``: ``[H, W]`` or ``[H, W, C]`` (a tensor stays on its
    device). One channel comes back as ``[H, W]``, as in the JAX package.
    """
    x = _f32(original)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    residual, recon = _wavefront_dpcm(x.contiguous(), coefficients, quant_step)
    if squeeze or x.shape[2] == 1:
        residual, recon = residual[:, :, 0], recon[:, :, 0]
    return (residual, recon) if return_recon else residual


def _wavefront_dpcm_inverse(r: torch.Tensor, first_row: torch.Tensor, first_col: torch.Tensor,
                            coefficients, quant_step: float) -> torch.Tensor:
    """Decoder wavefront over ``[H, W, C]`` residuals: ``rec = pred + r*q``."""
    wf = _Wavefront(tuple(r.shape), coefficients, quant_step, r.device)
    init = torch.zeros_like(r)
    init[0] = first_row
    init[:, 0] = first_col
    rec = wf.to_diagonals(init)
    rd = wf.to_diagonals(r)
    for step in wf.steps:
        s, n = step[0], step[-1]
        pred, scratch = wf.predict(rec, step)
        if wf.q != 1.0:
            torch.mul(rd[s:s + n], wf.q, out=scratch)
            torch.add(pred, scratch, out=rec[s:s + n])
        else:
            torch.add(pred, rd[s:s + n], out=rec[s:s + n])
    return wf.to_raster(rec)


def reconstruct_from_residual(residual, first_row, first_col, coefficients,
                              quant_step: float = 1.0) -> torch.Tensor:
    """Inverse closed-loop DPCM (the decoder side of the ch2 codec):
    ``[H, W]`` or ``[H, W, C]`` residuals and the verbatim first row and
    column -> the reconstruction, on the residuals' device."""
    r = _f32(residual)
    first_row = _f32(first_row).to(r.device)
    first_col = _f32(first_col).to(r.device)
    squeeze = r.ndim == 2
    if squeeze:
        r = r[:, :, None]
        first_row, first_col = first_row.reshape(-1, 1), first_col.reshape(-1, 1)
    out = _wavefront_dpcm_inverse(r.contiguous(), first_row, first_col, coefficients, quant_step)
    return out[:, :, 0] if squeeze else out
