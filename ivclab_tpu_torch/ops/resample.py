"""Sampling-rate conversion and filtering.

Port of ``ivclab_tpu/ops/resample.py`` (the course reference's
downsample/upsample/interpolation_upsample/lowpass_filter/FilterPipeline
and the scipy routines it leans on: ``scipy.signal.decimate`` in its FIR
and IIR forms, ``scipy.signal.resample``, ``scipy.ndimage.zoom(order=1)``).
Inputs are tensors, which stay on their device, or numpy arrays, which go
to the CPU; :class:`FilterPipeline` takes a device.

Every filter here is elementwise IEEE arithmetic in a fixed order, so the
card and the CPU give the same bits:

- the FIR filters (:func:`decimate`, :func:`lowpass_filter`) are ordered
  sums over the taps, one tensor operation per tap: ``acc + t_k * x_k`` in
  float64, whose product of two float32 values is exact (so a fused and an
  unfused multiply-add agree), rounded to float32 once at the end. The JAX
  package runs them as XLA convolutions, whose float32 sums come within
  1e-4 of these on 0-255 planes;
- the IIR filter (:func:`decimate_iir`) is a sequential loop along the
  filtered axis, run across the other axis at once, in XLA:CPU's
  arithmetic for the JAX package's ``lax.scan`` body: each update is a
  fused multiply-add, ``y = fma(b0, x, z0)``, ``z'_i = fma(-a_i, y,
  fma(b_i, x, z_i))`` and ``z'_7 = fma(b8, x, -(a8 * y))``. Each FMA is
  computed in float64 (exact product, one rounding of the sum) and rounded
  to float32, which equals the JAX package's output bit for bit on the
  planes the tests sweep.

Only :func:`fft_resample` goes through a library transform (``torch.fft``:
cuFFT on the card, pocketfft on the CPU), so its last bits differ between
devices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ivclab_tpu_torch.ops.color import _f32
from ivclab_tpu_torch.utils.shape import as_tensor, pad2d


def downsample(image, factor: int = 2) -> torch.Tensor:
    """Keep every ``factor``-th pixel of the first two axes."""
    return as_tensor(image)[0::factor, 0::factor]


def upsample(image, factor: int = 2) -> torch.Tensor:
    """Zero-insertion upsampling of the first two axes."""
    x = as_tensor(image)
    out = x.new_zeros((factor * x.shape[0], factor * x.shape[1]) + tuple(x.shape[2:]))
    out[0::factor, 0::factor] = x
    return out


def interpolation_upsample(image, factor: int = 2, classic: bool = False) -> torch.Tensor:
    """Bilinear upsampling with ``scipy.ndimage.zoom(order=1)``'s
    corner-aligned sample positions (output ``factor*H x factor*W``);
    ``classic`` is zero insertion."""
    if classic:
        return upsample(image, factor)
    x = _f32(image)
    H, W = x.shape[0], x.shape[1]
    oH, oW = factor * H, factor * W

    def axis_weights(n, on):
        pos = torch.arange(on, dtype=torch.float32, device=x.device) * float(
            np.float32((n - 1) / (on - 1)))
        i0 = torch.floor(pos).to(torch.int64).clamp(0, n - 2)
        return i0, pos - i0.to(torch.float32)

    y0, fy = axis_weights(H, oH)
    x0, fx = axis_weights(W, oW)
    fy = fy.reshape(-1, *([1] * (x.ndim - 1)))
    fx = fx.reshape(1, -1, *([1] * (x.ndim - 2)))
    top = x[y0][:, x0] * (1 - fx) + x[y0][:, x0 + 1] * fx
    bot = x[y0 + 1][:, x0] * (1 - fx) + x[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


@functools.lru_cache(maxsize=None)
def antialias_fir_taps(q: int) -> np.ndarray:
    """Hamming-windowed sinc lowpass, length ``20*q + 1``, cutoff ``1/q``,
    unity DC gain: the design scipy's ``decimate(ftype='fir')`` uses."""
    numtaps = 20 * q + 1
    cutoff = 1.0 / q
    n = np.arange(numtaps) - (numtaps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * n)
    h *= np.hamming(numtaps)
    h /= h.sum()
    h = h.astype(np.float32)
    h.setflags(write=False)
    return h


def _tap_sum(xp: torch.Tensor, weights, shape, window) -> torch.Tensor:
    """``sum_k w_k * window(xp, k)`` for k in order, accumulated in float64
    from the first product and rounded to float32 once. ``window(xp, k)``
    is tap k's view of the padded input, of ``shape``."""
    acc = torch.zeros(shape, dtype=torch.float64, device=xp.device)
    for k, w in enumerate(weights):
        acc = torch.add(acc, window(xp, k), alpha=float(w))
    return acc.to(torch.float32)


def _fir_axis(x: torch.Tensor, taps: np.ndarray, axis: int, boundary: str,
              step: int = 1) -> torch.Tensor:
    """Same-size convolution of a 2-D plane with ``taps`` along ``axis``
    (``boundary`` 'zero' or 'symmetric'), keeping every ``step``-th output."""
    k = taps.shape[0]
    lo, hi = (k - 1) // 2, k // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (lo, hi)
    xp = pad2d(x, pad, "constant" if boundary == "zero" else "symmetric").to(torch.float64)
    shape = list(x.shape)
    shape[axis] = m = -(-shape[axis] // step)

    def window(t, j):
        sl = [slice(None), slice(None)]
        sl[axis] = slice(j, j + step * (m - 1) + 1, step)
        return t[tuple(sl)]

    return _tap_sum(xp, taps[::-1], tuple(shape), window)  # a convolution: taps reversed


def decimate(x, q: int = 2, axis: int = 0) -> torch.Tensor:
    """FIR anti-alias filter + keep every ``q``-th sample, zero phase, zero
    boundary: ``scipy.signal.decimate(x, q, ftype='fir', zero_phase=True)``.
    Only the kept outputs are computed."""
    x = _f32(x)
    if x.ndim != 2:
        raise ValueError("decimate expects a 2-D plane")
    return _fir_axis(x, antialias_fir_taps(q), axis, "zero", step=q)


# scipy.signal.cheby1(8, 0.05, 0.8/2), the anti-alias IIR that
# scipy.signal.decimate(q=2) defaults to, and scipy.signal.lfilter_zi(b, a),
# the steady-state initial conditions filtfilt seeds each pass with (scaled
# by the first extended sample); the JAX package's constants.
_CHEBY1_Q2_B = np.array([
    0.00069873707728414, 0.00558989661827313, 0.01956463816395597,
    0.03912927632791193, 0.04891159540988991, 0.03912927632791193,
    0.01956463816395597, 0.00558989661827313, 0.00069873707728414,
])
_CHEBY1_Q2_A = np.array([
    1.0, -3.159100504614808, 5.967108107202708, -7.519348642687463,
    6.827184931315479, -4.482072321959029, 2.070876731225458,
    -0.6163275358434664, 0.09158859355707848,
])
_CHEBY1_Q2_ZI = np.array([
    0.9935613368756748, -2.1529960610857475, 3.760296648702961,
    -3.7550207651814698, 2.9840650341088955, -1.511409800512511,
    0.528015613259219, -0.09036414472602423,
])


def _lfilter(ext: torch.Tensor, z0: torch.Tensor) -> torch.Tensor:
    """Order-8 IIR (direct form II transposed) over axis 0 of ``[L, B]``
    float32 from the ``[8, B]`` float32 state ``z0``, every column at once.

    One step is four tensor operations: ``y = z_0 + b0*x``, the spare
    state row ``-(a8*y)`` rounded to float32, ``t_i = z_{i+1} + b_{i+1}*x``
    over the eight rows (the last one ``-(a8*y) + b8*x``), then
    ``z'_i = t_i - a_{i+1}*y`` (``a`` of the last row taken as 0). Each sum
    of a float32 value and a product runs in float64, where the product is
    exact, and is stored rounded to float32: an exactly rounded FMA.
    """
    b = _CHEBY1_Q2_B.astype(np.float32).astype(np.float64)
    a = _CHEBY1_Q2_A.astype(np.float32).astype(np.float64)
    dev = ext.device
    x64 = ext.to(torch.float64)
    bcol = torch.tensor(b[1:], dtype=torch.float64, device=dev)[:, None]
    acol = torch.tensor(np.append(-a[1:-1], 0.0), dtype=torch.float64, device=dev)[:, None]
    L, B = ext.shape
    state = torch.empty((9, B), dtype=torch.float32, device=dev)  # row 8: the spare
    state[:8] = z0
    nxt = torch.empty_like(state)
    t = torch.empty((8, B), dtype=torch.float32, device=dev)
    y = torch.empty((L, B), dtype=torch.float32, device=dev)
    b0, neg_a8 = float(b[0]), float(-a[-1])
    for k in range(L):
        xk, yk = x64[k], y[k]
        torch.add(state[0], xk, alpha=b0, out=yk)
        torch.mul(yk, neg_a8, out=state[8])
        torch.addcmul(state[1:], bcol, xk, out=t)
        torch.addcmul(t, acol, yk, out=nxt[:8])
        state, nxt = nxt, state
    return y


def _filtfilt(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Zero-phase IIR along ``axis`` of ``[H, W, ...]`` (every other entry a
    column of the scan): scipy's filtfilt defaults, odd reflection over
    ``3 * 9`` samples and each pass seeded with ``lfilter_zi`` times its
    first sample."""
    pad = 3 * max(len(_CHEBY1_Q2_B), len(_CHEBY1_Q2_A))
    xt = x.movedim(axis, 0)
    rest = xt.shape[1:]
    xt = xt.reshape(xt.shape[0], -1)
    top = 2.0 * xt[0] - torch.flip(xt[1:pad + 1], (0,))
    bot = 2.0 * xt[-1] - torch.flip(xt[-pad - 1:-1], (0,))
    ext = torch.cat([top, xt, bot], dim=0)
    zi = torch.from_numpy(_CHEBY1_Q2_ZI.astype(np.float32)).to(x.device)[:, None]
    y = _lfilter(ext, zi * ext[0][None, :])
    yr = torch.flip(y, (0,))
    y = torch.flip(_lfilter(yr, zi * yr[0][None, :]), (0,))
    y = y[pad:-pad].reshape(-1, *rest)
    return y.movedim(0, axis)


def _decimate_iir(x: torch.Tensor, axis: int) -> torch.Tensor:
    """:func:`decimate_iir` by 2 along ``axis`` of ``[H, W, ...]``."""
    y = _filtfilt(x, axis)
    return y[0::2] if axis == 0 else y[:, 0::2]


def decimate_iir(x, q: int = 2, axis: int = 0) -> torch.Tensor:
    """IIR anti-alias decimate: ``scipy.signal.decimate(x, q)``'s defaults
    (order-8 Chebyshev-I, zero phase through filtfilt). Only q=2, the
    factor the course reference uses."""
    if q != 2:
        raise NotImplementedError("decimate_iir supports q=2 only")
    x = _f32(x)
    if x.ndim != 2:
        raise ValueError("decimate_iir expects a 2-D plane")
    return _decimate_iir(x, axis)


def fft_resample(x, num: int, axis: int = 0) -> torch.Tensor:
    """Fourier-domain resampling of a real signal along ``axis`` to ``num``
    samples (``scipy.signal.resample``): the spectrum is cut or zero-padded
    at its middle, an even-length Nyquist bin split in two on upsampling
    and folded on downsampling."""
    x = _f32(x)
    n = x.shape[axis]
    if num == n:
        return x
    X = torch.fft.fft(x, dim=axis)
    keep = min(n, num)
    nyq = keep // 2 + 1
    shape = list(X.shape)
    shape[axis] = num
    Y = torch.zeros(shape, dtype=X.dtype, device=X.device)

    def sl(a, start, stop):
        return a.narrow(axis, start, stop - start)

    sl(Y, 0, nyq).copy_(sl(X, 0, nyq))
    neg = keep - nyq
    if neg > 0:
        sl(Y, num - neg, num).copy_(sl(X, n - neg, n))
    if keep % 2 == 0:
        if num > n:  # split the Nyquist bin between the +/- frequencies
            half = sl(X, nyq - 1, nyq) * 0.5
            sl(Y, nyq - 1, nyq).copy_(half)
            sl(Y, num - nyq + 1, num - nyq + 2).copy_(half.conj())
        else:  # fold the mirrored bin into the new Nyquist bin
            sl(Y, nyq - 1, nyq).add_(sl(X, n - nyq + 1, n - nyq + 2))
    return (torch.fft.ifft(Y, dim=axis) * (num / n)).real.contiguous()


# scipy.signal.resample under the course reference's import name
resample = fft_resample


def lowpass_filter(image, kernel) -> torch.Tensor:
    """Normalized-kernel 2-D convolution, symmetric boundary, same size
    (scipy ``convolve2d(mode='same', boundary='symm')``), on ``[H, W]`` or
    every channel of ``[H, W, C]``: an ordered sum over the kernel's taps."""
    x = _f32(image)
    kernel = np.asarray(kernel, dtype=np.float64)
    kernel = (kernel / kernel.sum()).astype(np.float32)
    kh, kw = kernel.shape
    H, W = x.shape[0], x.shape[1]
    xp = pad2d(x, ((kh // 2, (kh - 1) // 2), (kw // 2, (kw - 1) // 2)), "symmetric")
    xp = xp.to(torch.float64)
    flipped = kernel[::-1, ::-1]  # a convolution: the kernel reversed
    taps = [(u, v) for u in range(kh) for v in range(kw)]
    return _tap_sum(xp, [flipped[u, v] for u, v in taps], tuple(x.shape),
                    lambda t, k: t[taps[k][0]:taps[k][0] + H, taps[k][1]:taps[k][1] + W])


class FilterPipeline:
    """Pre-filter -> decimate x2 -> FFT-resample back -> post lowpass
    (the course reference's pipeline, with ``filter_img`` a method), on
    ``device``."""

    PRE_KERNEL = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float64)
    POST_KERNEL = np.array([[1, 1, 1], [1, 2, 1], [1, 1, 1]], dtype=np.float64)

    def __init__(self, kernel=None, device: str | torch.device = "cuda"):
        kernel = self.PRE_KERNEL if kernel is None else np.asarray(kernel, dtype=np.float64)
        self.kernel = kernel / kernel.sum()
        self.device = torch.device(device)

    def filter_img(self, image, prefilter: bool = True) -> torch.Tensor:
        """``[H, W]`` or ``[H, W, C]`` image -> uint8 tensor of its shape on
        the pipeline's device."""
        x = _f32(image).to(self.device)
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, :, None]
        H, W = x.shape[0], x.shape[1]

        def per_channel(plane):
            out = plane
            if prefilter:
                out = lowpass_filter(out, self.kernel)
            out = decimate(decimate(out, 2, axis=0), 2, axis=1)
            out = fft_resample(fft_resample(out, H, axis=0), W, axis=1)
            return lowpass_filter(out, self.POST_KERNEL)

        out = torch.stack([per_channel(x[:, :, c]) for c in range(x.shape[2])], dim=-1)
        out = torch.round(out).clamp(0, 255).to(torch.uint8)
        return out[..., 0] if squeeze else out
