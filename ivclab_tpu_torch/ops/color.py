"""BT.601 and ICT colour transforms.

Port of ``ivclab_tpu/ops/color.py``. Each output channel is a three-term
float32 sum, and the codec's quantized symbols depend on its last bit (a
DCT coefficient near k+1/2 rounds either way), so the sums follow the JAX
package's CPU arithmetic, on every device: output channels 0 and 1 are
``(x0*m0 + x1*m1) + x2*m2`` with every product and sum rounded to
float32, and channel 2 is the fused-multiply-add chain
``fma(x2, m2, fma(x1, m1, x0*m0))``. Each torch operation below is its own
kernel, so nothing is contracted behind the code's back.

The fused steps run in float64: the product of two float32 values is
exact there and the sum rounds once in float64, then once to float32. On
8-bit inputs that float64 sum is exact, so the step is an exactly rounded
FMA; the double rounding has not been seen to change a value on the
inverses' non-integer inputs either.

What differs from the JAX package is XLA:CPU itself: its code for the
dot's last pixels, past a multiple of 16, sums in another order. So each
transform here (forward and inverse, BT.601 and ICT) equals the JAX
package's eager call bit for bit when the pixel count H*W is a multiple of
16, and within one float32 ulp at 256 (2**-15) elsewhere: the ICT inverse
at 45x61 rounds 1 value of 8,235 differently, its last pixel's channel 0,
a plain sum. The intra codec's symbols and bytes equal the JAX package's
on such shapes too (45x61 and 41x57 in the tests): a difference in the
last bit rarely moves a scaled coefficient across k + 1/2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Forward BT.601 RGB -> YCbCr (full-range, JPEG convention)
_RGB2YCBCR = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float32,
)
_YCBCR_OFFSET = np.array([0.0, 128.0, 128.0], dtype=np.float32)

# Exact inverse used by the course reference
_YCBCR2RGB = np.array(
    [
        [1.0, 0.0, 1.402],
        [1.0, -0.344136, -0.714136],
        [1.0, 1.772, 0.0],
    ],
    dtype=np.float32,
)

# Irreversible Color Transform (JPEG2000 ICT): the reference's ch1 study
# uses these rounded coefficients and no chroma offset.
_RGB2YCBCR_ICT = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.16875, -0.33126, 0.5],
        [0.5, -0.41869, -0.08131],
    ],
    dtype=np.float32,
)
_YCBCR2RGB_ICT = np.array(
    [
        [1.0, 0.0, 1.402],
        [1.0, -0.34413, -0.71414],
        [1.0, 1.772, 0.0],
    ],
    dtype=np.float32,
)


def _f32(image) -> torch.Tensor:
    if isinstance(image, torch.Tensor):
        return image.to(torch.float32)
    return torch.from_numpy(np.asarray(image, dtype=np.float32).copy())


def _fma(a: torch.Tensor, m: float, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * m + c``: the product is exact in float64, the sum rounds
    in float64 and again to float32 (one rounding when it is exact in
    float64, as for 8-bit inputs)."""
    return (a.to(torch.float64) * m + c.to(torch.float64)).to(torch.float32)


def _mat3(x: torch.Tensor, M: np.ndarray) -> torch.Tensor:
    """``x @ M.T`` over the last axis, in the JAX package's CPU order."""
    m = [[float(v) for v in row] for row in M]
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    out = []
    for r in range(2):
        out.append(x0 * m[r][0] + x1 * m[r][1] + x2 * m[r][2])
    out.append(_fma(x2, m[2][2], _fma(x1, m[2][1], x0 * m[2][0])))
    return torch.stack(out, dim=-1)


def rgb2ycbcr_ict(image) -> torch.Tensor:
    """RGB -> ICT YCbCr (no chroma offset; Cb/Cr centered at 0)."""
    return _mat3(_f32(image), _RGB2YCBCR_ICT)


def ycbcr2rgb_ict(image) -> torch.Tensor:
    """ICT YCbCr -> RGB, unclipped (callers round and clip at the end)."""
    return _mat3(_f32(image), _YCBCR2RGB_ICT)


def rgb2gray(image) -> torch.Tensor:
    """Channel-mean grayscale, keepdims: ``((r + g) + b) * f32(1/3)``, the
    JAX package's CPU arithmetic."""
    x = _f32(image)
    return (((x[..., 0] + x[..., 1]) + x[..., 2]) * float(np.float32(1 / 3)))[..., None]


@functools.lru_cache(maxsize=None)
def _offset(device: torch.device) -> torch.Tensor:
    """The chroma offset on ``device``, uploaded once (an upload a call
    would make the host wait for the card each time)."""
    return torch.from_numpy(_YCBCR_OFFSET.copy()).to(device)


def rgb2ycbcr(image) -> torch.Tensor:
    """RGB -> YCbCr: ``x @ M.T + (0, 128, 128)``."""
    x = _f32(image)
    return _mat3(x, _RGB2YCBCR) + _offset(x.device)


def ycbcr2rgb(image) -> torch.Tensor:
    """YCbCr -> RGB with clip to [0, 255]."""
    x = _f32(image)
    rgb = _mat3(x - _offset(x.device), _YCBCR2RGB)
    return rgb.clamp(0.0, 255.0)

