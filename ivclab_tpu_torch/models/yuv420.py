"""YUV 4:2:0 and ICT chroma-subsampling codecs.

Port of ``ivclab_tpu/models/yuv420.py``: chroma planes are symmetrically
padded, decimated by 2 per axis, rounded, re-padded, FFT-resampled back,
cropped, recombined and converted to RGB, all on the codec's device. The
result is a uint8 tensor on that device. Its levels may differ from the
JAX package's by 1 where a value lies next to k + 1/2 before the final
rounding: the decimation sums its taps in another order than XLA's
convolution, and torch.fft rounds otherwise than jnp.fft.
"""

from __future__ import annotations

import torch

from ivclab_tpu_torch.ops.color import (
    _f32,
    rgb2ycbcr,
    rgb2ycbcr_ict,
    ycbcr2rgb,
    ycbcr2rgb_ict,
)
from ivclab_tpu_torch.ops.resample import decimate, fft_resample
from ivclab_tpu_torch.utils.shape import as_tensor, pad2d

_PAD_HIGH = 4
_PAD_LOW = 2


def pad_image(img, resolution: str = "high") -> torch.Tensor:
    """Symmetric padding: 4 px at full resolution, 2 px at half."""
    pad = _PAD_HIGH if resolution == "high" else _PAD_LOW
    return pad2d(as_tensor(img), ((pad, pad), (pad, pad)), "symmetric")


def crop_image(img, resolution: str = "high") -> torch.Tensor:
    pad = _PAD_HIGH if resolution == "high" else _PAD_LOW
    return as_tensor(img)[pad:-pad, pad:-pad]


def _to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    return torch.round(rgb).clamp(0, 255).to(torch.uint8)


def yuv420compression(image, device: str | torch.device = "cuda") -> torch.Tensor:
    """RGB -> YCbCr 4:2:0 -> reconstructed RGB uint8, on ``device``."""
    x = _f32(image).to(device)
    ycbcr = rgb2ycbcr(x)
    Y, Cb, Cr = ycbcr[:, :, 0], ycbcr[:, :, 1], ycbcr[:, :, 2]

    def down(plane):
        p = pad_image(plane, "high")
        return torch.round(decimate(decimate(p, 2, axis=0), 2, axis=1))

    Hp, Wp = Y.shape[0] + 2 * _PAD_HIGH, Y.shape[1] + 2 * _PAD_HIGH

    def up(plane):
        p = pad_image(plane, "low")
        p = fft_resample(fft_resample(p, Hp, axis=0), Wp, axis=1)
        return crop_image(p, "high")

    ycbcr_rec = torch.stack([torch.round(Y), up(down(Cb)), up(down(Cr))], dim=2)
    return _to_uint8(ycbcr2rgb(ycbcr_rec))


def ict_compression(image, chroma_mode: str = "fft",
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """ICT (offset-free) + 4:2:0 chroma subsampling codec, the course's two
    ch1 ICT studies:

    - ``chroma_mode="fft"``: mirror-pad 4 + FFT-resample down with a
      centred crop, mirror-pad 4 + FFT-resample up;
    - ``chroma_mode="fir"``: zero-phase FIR decimate down, plain FFT
      resample up.

    Y stays full resolution and rounded. Returns the RGB uint8 tensor on
    ``device`` (nominally 8 * (1 + 2/4) = 12 bpp).
    """
    if chroma_mode not in ("fft", "fir"):
        raise ValueError("chroma_mode must be 'fft' or 'fir'")
    x = _f32(image).to(device)
    ycbcr = rgb2ycbcr_ict(x)
    Y, Cb, Cr = ycbcr[:, :, 0], ycbcr[:, :, 1], ycbcr[:, :, 2]
    H, W = Y.shape

    if chroma_mode == "fft":

        def down(plane):
            p = pad2d(plane, ((4, 4), (4, 4)), "symmetric")
            d = fft_resample(fft_resample(p, p.shape[0] // 2, axis=0), p.shape[1] // 2, axis=1)
            cy = (d.shape[0] - H // 2) // 2
            cx = (d.shape[1] - W // 2) // 2
            return torch.round(d[cy:-cy, cx:-cx])

        def up(plane):
            p = pad2d(plane, ((4, 4), (4, 4)), "symmetric")
            u = fft_resample(fft_resample(p, H + 8, axis=0), W + 8, axis=1)
            return u[4:-4, 4:-4]

    else:

        def down(plane):
            return torch.round(decimate(decimate(plane, 2, axis=0), 2, axis=1))

        def up(plane):
            return fft_resample(fft_resample(plane, H, axis=0), W, axis=1)

    ycbcr_rec = torch.stack([torch.round(Y), up(down(Cb)), up(down(Cr))], dim=2)
    return _to_uint8(ycbcr2rgb_ict(ycbcr_rec))
