"""The port's ch1 signal library against the JAX package (and the scipy
oracles the course reference uses): resampling, filtering, the YUV 4:2:0
and ICT codecs, the colour transforms' rule, and the ch1 metrics.

Inputs are made with numpy from fixed seeds and go to both packages on
the CPU. Tolerances, with their reasons:

- exact: downsample, upsample, the IIR decimate (the port repeats XLA:CPU's
  FMA order), and bilinear upsampling and the 3x3 lowpass as measured;
- FIR_TOL = 1e-4 on 0-255 planes: the FIR filters sum their taps in a
  fixed order in float64, the JAX package in XLA's float32 convolution
  order (3.1e-5 measured on sail's Cb);
- FFT_TOL = 1e-3: torch.fft and jnp.fft round the transform otherwise
  (1.7e-4 measured at 0-255);
- uint8 outputs within 1 level, with the count of differing values
  bounded by UINT8_SHARE of the values (a value next to k + 1/2 before the
  final rounding may land either way).
"""

import importlib

import numpy as np
import pytest
import scipy.signal as ssig
import torch
from scipy.ndimage import zoom

from torch_parity import assert_close, assert_exact, to_numpy

from ivclab_tpu.models.yuv420 import ict_compression as j_ict, yuv420compression as j_yuv420
from ivclab_tpu.ops import color as jcolor
from ivclab_tpu.utils import metrics as jmetrics

from ivclab_tpu_torch.models.yuv420 import (
    crop_image,
    ict_compression,
    pad_image,
    yuv420compression,
)
from ivclab_tpu_torch.ops import color as tcolor
from ivclab_tpu_torch.ops.resample import (
    FilterPipeline,
    antialias_fir_taps,
    decimate,
    decimate_iir,
    downsample,
    fft_resample,
    interpolation_upsample,
    lowpass_filter,
    upsample,
)
from ivclab_tpu_torch.utils import calc_mse, calc_psnr

# ``ivclab_tpu.ops`` exports a function named ``resample`` that hides the module
jres = importlib.import_module("ivclab_tpu.ops.resample")
jyuv = importlib.import_module("ivclab_tpu.models.yuv420")

FIR_TOL = 1e-4
FFT_TOL = 1e-3
UINT8_SHARE = 1e-3


def _plane(seed, shape, scale=255.0):
    return (np.random.default_rng(seed).random(shape) * scale).astype(np.float32)


def assert_uint8_close(port, ref, what: str):
    """Within 1 level, and at most UINT8_SHARE of the values differing."""
    p, r = to_numpy(port).astype(np.int64), np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape, f"{what}: shape {p.shape} != {r.shape}"
    n = int((p != r).sum())
    print(f"{what}: {n} of {p.size} uint8 values differ by 1")
    assert np.abs(p - r).max() <= 1, f"{what}: a value differs by more than 1 level"
    assert n <= UINT8_SHARE * p.size, f"{what}: {n} of {p.size} values differ"


# ------------------------------------------------------------ ch1 signal


def test_downsample_upsample():
    x = _plane(1, (16, 20, 3), 1.0)
    d = downsample(torch.from_numpy(x))
    assert_exact(d.numpy().view(np.int32), np.asarray(jres.downsample(x)).view(np.int32), "down")
    assert d.shape == (8, 10, 3)
    u = upsample(d)
    assert_exact(u.numpy().view(np.int32), np.asarray(jres.upsample(d.numpy())).view(np.int32),
                 "up")
    assert u.shape == (16, 20, 3) and float(u[1::2].sum()) == 0.0


@pytest.mark.parametrize("shape", [(12, 14), (12, 14, 3)])
def test_interpolation_upsample_matches_jax_and_zoom(shape):
    x = _plane(2, shape, 1.0)
    ours = interpolation_upsample(x, 2).numpy()
    assert_close(ours, jres.interpolation_upsample(x, 2), 1e-4, "vs JAX")
    if len(shape) == 2:
        ref = zoom(x, 2, order=1)
        assert ours.shape == ref.shape
        # interior agreement (edge extrapolation conventions differ slightly)
        assert np.abs(ours[2:-2, 2:-2] - ref[2:-2, 2:-2]).max() < 0.08
    assert_exact(interpolation_upsample(x, 2, classic=True).numpy().view(np.int32),
                 np.asarray(jres.interpolation_upsample(x, 2, classic=True)).view(np.int32),
                 "classic (bits)")


@pytest.mark.parametrize("shape", [(24, 30), (24, 30, 3), (37, 29)])
def test_lowpass_filter_matches_jax_and_convolve2d(shape):
    x = _plane(3, shape)
    kernel = np.array([[1.0, 2, 1], [2, 4, 2], [1, 2, 1]])
    ours = lowpass_filter(x, kernel).numpy()
    assert_close(ours, jres.lowpass_filter(x, kernel), FIR_TOL, "vs JAX")
    planes = [x] if x.ndim == 2 else [x[:, :, c] for c in range(3)]
    for c, p in enumerate(planes):
        ref = ssig.convolve2d(p.astype(np.float64), kernel / kernel.sum(), mode="same",
                              boundary="symm")
        got = ours if x.ndim == 2 else ours[:, :, c]
        assert np.abs(got - ref).max() < 1e-2
    k5 = np.arange(1.0, 21.0).reshape(4, 5)  # even-sized, asymmetric
    assert_close(lowpass_filter(x, k5), jres.lowpass_filter(x, k5), FIR_TOL, "4x5 kernel")


@pytest.mark.parametrize("axis", [0, 1])
def test_decimate_matches_jax_and_scipy(axis):
    x = _plane(4, (64, 80))
    ours = decimate(x, 2, axis=axis).numpy()
    ref = ssig.decimate(x.astype(np.float64), 2, axis=axis, ftype="fir", zero_phase=True)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() < 1e-3
    assert_close(ours, jres.decimate(x, 2, axis=axis), FIR_TOL, "vs JAX")
    assert_close(decimate(x, 3, axis=axis), jres.decimate(x, 3, axis=axis), FIR_TOL, "q=3")
    assert np.array_equal(antialias_fir_taps(2), jres.antialias_fir_taps(2))
    with pytest.raises(ValueError):
        decimate(np.zeros((4, 4, 2)))


@pytest.mark.parametrize("n,num", [(40, 80), (80, 40), (31, 62), (62, 31), (33, 20), (20, 33)])
def test_fft_resample_matches_jax_and_scipy(n, num):
    x = _plane(5, (n, 8), 1.0)
    ref = ssig.resample(x.astype(np.float64), num, axis=0)
    ours = fft_resample(x, num, axis=0).numpy()
    assert np.abs(ours - ref).max() < 1e-4, (n, num)
    x255 = x * 255
    assert_close(fft_resample(x255, num, axis=0), jres.fft_resample(x255, num, axis=0),
                 FFT_TOL, "vs JAX, axis 0")
    assert_close(fft_resample(x255.T, num, axis=1), jres.fft_resample(x255.T, num, axis=1),
                 FFT_TOL, "vs JAX, axis 1")


def test_filter_pipeline_matches_jax(lena):
    out = FilterPipeline(device="cpu").filter_img(lena[:64, :64])
    assert out.shape == (64, 64, 3) and out.dtype == torch.uint8
    assert_uint8_close(out, jres.FilterPipeline().filter_img(lena[:64, :64]), "FilterPipeline")
    # lowpassed output should still be a decent reconstruction
    assert float(calc_psnr(lena[:64, :64], out)) > 20.0


def test_yuv420_matches_jax(lena):
    rec = yuv420compression(lena, device="cpu")
    assert tuple(rec.shape) == lena.shape and rec.dtype == torch.uint8
    # chroma-only degradation: high PSNR expected
    assert float(calc_psnr(lena, rec)) > 30.0
    assert_uint8_close(rec, j_yuv420(lena), "yuv420compression")


@pytest.mark.parametrize("shape", [(16, 16), (16, 16, 3)])
def test_pipeline_shapes(shape):
    x = _plane(6, shape)
    out = FilterPipeline(device="cpu").filter_img(x)
    assert tuple(out.shape) == shape
    assert_uint8_close(out, jres.FilterPipeline().filter_img(x), f"pipeline {shape}")


# ------------------------------------------- beyond the JAX package's tests


@pytest.mark.parametrize("mode", ["fft", "fir"])
@pytest.mark.parametrize("name", ["lena", "sail"])
def test_ict_compression_matches_jax(mode, name, lena, sail):
    img = lena if name == "lena" else sail
    rec = ict_compression(img, mode, device="cpu")
    assert tuple(rec.shape) == img.shape and rec.dtype == torch.uint8
    assert_uint8_close(rec, j_ict(img, mode), f"ict {mode} {name}")
    with pytest.raises(ValueError):
        ict_compression(img, "nope", device="cpu")


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("source", ["sail Cb", "lena Cr", "random 61x45"])
def test_decimate_iir_matches_jax_bit_for_bit(axis, source, sail, lena):
    """XLA:CPU's FMA order, repeated: the IIR equals the JAX package exactly."""
    if source == "sail Cb":
        x = np.ascontiguousarray(np.asarray(jcolor.rgb2ycbcr(sail))[:, :, 1])
    elif source == "lena Cr":
        x = np.ascontiguousarray(np.asarray(jcolor.rgb2ycbcr(lena))[:, :, 2])
    else:
        x = _plane(7, (61, 45))
    ours = decimate_iir(x, 2, axis=axis).numpy()
    assert_exact(ours.view(np.int32), np.asarray(jres.decimate_iir(x, 2, axis=axis)).view(np.int32),
                 f"decimate_iir {source} axis {axis} (bits)")
    ref = ssig.decimate(x.astype(np.float64), 2, axis=axis)  # scipy's IIR default, float64
    assert np.abs(ours - ref).max() < 5e-3
    with pytest.raises(NotImplementedError):
        decimate_iir(x, 3)


def test_pad_and_crop_match_jax(lena):
    plane = lena[:40, :48, 0].astype(np.float32)
    for res in ("high", "low"):
        padded = pad_image(plane, res)
        assert_exact(padded, jyuv.pad_image(plane, res), f"pad {res}")
        assert_exact(crop_image(padded, res), plane, f"crop {res}")


_TRANSFORMS = {
    "rgb2ycbcr": (tcolor.rgb2ycbcr, jcolor.rgb2ycbcr, None),
    "ycbcr2rgb": (tcolor.ycbcr2rgb, jcolor.ycbcr2rgb, jcolor.rgb2ycbcr),
    "rgb2ycbcr_ict": (tcolor.rgb2ycbcr_ict, jcolor.rgb2ycbcr_ict, None),
    "ycbcr2rgb_ict": (tcolor.ycbcr2rgb_ict, jcolor.ycbcr2rgb_ict, jcolor.rgb2ycbcr_ict),
}


@pytest.mark.parametrize("name", sorted(_TRANSFORMS))
def test_colour_rule_exact_at_multiples_of_16_pixels(name):
    """The colour transforms equal the JAX package's eager call bit for bit
    when H*W is a multiple of 16, and within one float32 ulp at 256
    (2**-15) elsewhere, where XLA:CPU sums the last pixels in another
    order (ops/color.py)."""
    port, jax_fn, make_input = _TRANSFORMS[name]
    rng = np.random.default_rng(11)
    shapes = [(H, W) for H in range(1, 9) for W in (1, 2, 3, 5, 8, 13, 16, 21, 32, 45)]
    exact = differing = 0
    for H, W in shapes:
        if True:
            img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
            x = img if make_input is None else np.asarray(make_input(img))
            t, j = port(x).numpy(), np.asarray(jax_fn(x))
            if (H * W) % 16 == 0:
                assert_exact(t.view(np.int32), j.view(np.int32), f"{name} {H}x{W} (bits)")
                exact += 1
            else:
                assert_close(t, j, 2.0**-15, f"{name} {H}x{W}")
                differing += int(not np.array_equal(t, j))
    print(f"{name}: {exact} shapes with H*W % 16 == 0 exact; {differing} of the other "
          f"{len(shapes) - exact} differ")
    assert exact == sum((H * W) % 16 == 0 for H, W in shapes) > 0


# ------------------------------------------------------------ ch1 metrics


def test_mse_matches_numpy(lena, lena_rec):
    ours = float(calc_mse(lena, lena_rec))
    ref = np.mean((lena.astype(np.float64) - lena_rec.astype(np.float64)) ** 2)
    assert abs(ours - ref) < 0.5
    # float32 means of ~8e5 squares in another order: relative 1e-6
    assert abs(ours - float(jmetrics.calc_mse(lena, lena_rec))) <= 1e-6 * ref


def test_psnr_matches_formula(lena, lena_rec):
    ours = float(calc_psnr(lena, lena_rec))
    mse = np.mean((lena.astype(np.float64) - lena_rec.astype(np.float64)) ** 2)
    assert abs(ours - 20 * np.log10(255.0 / np.sqrt(mse))) < 0.01
    assert abs(ours - float(jmetrics.calc_psnr(lena, lena_rec))) < 1e-4


def test_gray_rgb_coercion(lena):
    gray = lena.mean(axis=-1)
    mse = float(calc_mse(gray, lena))
    ref = np.mean((np.stack([gray] * 3, -1).astype(np.float64) - lena.astype(np.float64)) ** 2)
    assert abs(mse - ref) < 0.5
    assert abs(mse - float(jmetrics.calc_mse(gray, lena))) <= 1e-6 * ref


def test_golden_values(lena, lena_rec):
    """The JAX package's pinned golden values for the synthetic lena/lena_rec
    pair (tests/test_ch1_metrics.py)."""
    assert abs(float(calc_mse(lena, lena_rec)) - 1237.0134) < 2.0
    assert abs(float(calc_psnr(lena, lena_rec)) - 17.2071) < 0.2
