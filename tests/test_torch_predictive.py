"""The port's ch2 entropy statistics and predictive (DPCM) library against
the JAX package: the wavefront, the three predictors, ``PredictiveCodec``
and the residual-coding helpers.

Inputs are numpy arrays from the fixtures or fixed seeds, given to both
packages on the CPU. Exact: every residual, reconstruction and inverse of
the wavefront (the port repeats XLA:CPU's FMA order), the predictors,
``PredictiveCodec``'s bits and RGB without chroma subsampling, and the
helpers' codes and words. With ``subsample_chroma=True`` the codec's
chroma is decimated by the FIR filter, which sums its taps in another
order than XLA's convolution (last bits, FIR_TOL in test_torch_signal.py),
and the closed loop can turn a near-tie residual the other way; there the
luma residuals stay exact, the chroma mismatches are counted, and the bits
and PSNR are held within BITS_SHARE and PSNR_TOL.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_exact, to_numpy

from ivclab_tpu.entropy import stats_marg as j_marg
from ivclab_tpu.models import predictive as jpred
from ivclab_tpu.models.dpcm import PredictiveCodec as JPredictive
from ivclab_tpu.ops import predictive as jwave
from ivclab_tpu.ops.color import rgb2ycbcr as j_rgb2ycbcr
from ivclab_tpu.utils import huffman_helpers as jhelp

from ivclab_tpu_torch.entropy import (
    calc_entropy,
    min_code_length,
    smooth_pmf,
    stats_cond,
    stats_joint,
    stats_marg,
)
from ivclab_tpu_torch.models import PredictiveCodec
from ivclab_tpu_torch.models.predictive import (
    COEFFS_CBCR,
    COEFFS_Y,
    min_entropy_predictor,
    single_pixel_predictor,
    three_pixels_predictor,
)
from ivclab_tpu_torch.ops.predictive import predict_from_neighbors, reconstruct_from_residual
from ivclab_tpu_torch.utils import calc_psnr, huffman_helpers as thelp

BITS_SHARE = 5e-3  # total bits within 0.5% of JAX's with subsampled chroma
PSNR_TOL = 0.05    # dB, the same


def _bits(a) -> np.ndarray:
    return to_numpy(a).astype(np.float32).view(np.int32)


def _np_stats_marg(image, pixel_range):
    counts, _ = np.histogram(image.astype(np.float64).flatten(), bins=pixel_range)
    return counts / image.size


# ------------------------------------------ twins of tests/test_ch2_entropy.py


def test_stats_marg_matches_numpy(satpic1):
    ours = stats_marg(satpic1, np.arange(256)).numpy()
    assert np.abs(ours - _np_stats_marg(satpic1, np.arange(256))).max() < 1e-7
    assert_exact(_bits(ours), _bits(j_marg(satpic1, np.arange(256))), "vs JAX (bits)")


def test_stats_marg_residual_range(sail):
    res = single_pixel_predictor(sail, device="cpu").numpy()
    ours = stats_marg(res, np.arange(-255, 255)).numpy()
    assert np.abs(ours - _np_stats_marg(res, np.arange(-255, 255))).max() < 1e-7


def test_smooth_pmf():
    sm = np.asarray(smooth_pmf(np.array([0.5, 0.5, 0.0])))
    assert sm.min() > 0
    assert abs(sm.sum() - 1.0) < 1e-6


def test_entropy_golden(satpic1):
    h = float(calc_entropy(stats_marg(satpic1, np.arange(256))))
    assert abs(h - 7.3263) < 0.2


def test_cross_entropy_golden(satpic1, lena):
    target = stats_marg(satpic1, np.arange(256))
    common = stats_marg(lena, np.arange(256))
    cl = float(min_code_length(target, common))
    assert cl >= float(calc_entropy(target)) - 1e-3
    assert abs(cl - 7.4665) < 0.2


def test_joint_entropy_golden(satpic1):
    hj = float(calc_entropy(stats_joint(satpic1, np.arange(256))))
    # joint entropy of pairs is between H and 2H
    hm = float(calc_entropy(stats_marg(satpic1, np.arange(256))))
    assert hm <= hj + 1e-2 <= 2 * hm + 0.5
    assert abs(hj - 12.9829) < 0.2


def test_joint_matches_histogram2d(satpic1):
    img = satpic1
    pairs = img[:, : img.shape[1] // 2 * 2].reshape(img.shape[0], -1, 2, 3)
    pairs = pairs.transpose(0, 1, 3, 2).reshape(-1, 2)
    hist_range = np.arange(257)
    ref, _, _ = np.histogram2d(pairs[:, 0], pairs[:, 1], bins=[hist_range, hist_range])
    ref = (ref / ref.sum()).flatten()
    assert np.abs(stats_joint(img, np.arange(256)).numpy() - ref).max() < 1e-7


def test_cond_entropy_golden(satpic1):
    hc = float(stats_cond(satpic1, np.arange(256)))
    hm = float(calc_entropy(stats_marg(satpic1, np.arange(256))))
    assert 0 < hc <= hm + 0.05
    assert abs(hc - 5.6948) < 0.2


def test_single_pixel_predictor_entropy(sail):
    res = single_pixel_predictor(sail, device="cpu")
    assert tuple(res.shape) == sail.shape
    assert_exact(_bits(res), _bits(jpred.single_pixel_predictor(sail)), "vs JAX (bits)")
    h = float(calc_entropy(stats_marg(res, np.arange(-255, 255))))
    assert abs(h - 5.7509) < 0.2


def test_three_pixels_predictor_entropy(sail):
    res_y, res_c = three_pixels_predictor(sail, subsample_color_channels=False, device="cpu")
    jy, jc = jpred.three_pixels_predictor(sail, subsample_color_channels=False)
    assert res_y.dtype == torch.int32 and res_c.dtype == torch.int32
    assert_exact(res_y, jy, "Y residuals")
    assert_exact(res_c, jc, "CbCr residuals")
    merged = np.concatenate([res_y.numpy().ravel(), res_c.numpy().ravel()])
    h = float(calc_entropy(stats_marg(merged, np.arange(-255, 255))))
    # residual entropy must beat the raw-pixel entropy by a wide margin
    assert h < float(calc_entropy(stats_marg(sail, np.arange(256))))
    assert abs(h - 3.38) < 0.2


def test_three_pixels_predictor_subsampled_shapes(sail):
    res_y, res_c = three_pixels_predictor(sail, subsample_color_channels=True, device="cpu")
    H, W = sail.shape[:2]
    assert tuple(res_y.shape) == (H, W)
    assert tuple(res_c.shape) == (H // 2, W // 2, 2)
    # the IIR decimate repeats XLA:CPU's order, so even these are exact
    jy, jc = jpred.three_pixels_predictor(sail, subsample_color_channels=True)
    assert_exact(res_y, jy, "Y residuals")
    assert_exact(res_c, jc, "subsampled CbCr residuals")


def test_wavefront_matches_sequential_oracle():
    """The anti-diagonal wavefront must equal the textbook raster-order DPCM."""
    x = (np.random.default_rng(42).random((12, 9, 2)) * 255).astype(np.float64)
    coeffs = (7 / 8, -4 / 8, 5 / 8)
    recon = np.zeros_like(x)
    recon[0, :, :] = x[0, :, :]
    recon[:, 0, :] = x[:, 0, :]
    resid = np.zeros_like(x)
    H, W, C = x.shape
    for i in range(1, H):
        for j in range(1, W):
            for c in range(C):
                pred = (coeffs[0] * recon[i, j - 1, c] + coeffs[1] * recon[i - 1, j - 1, c]
                        + coeffs[2] * recon[i - 1, j, c])
                err = np.round(x[i, j, c] - pred)
                resid[i, j, c] = err
                recon[i, j, c] = pred + err
    ours = predict_from_neighbors(x, coeffs).numpy()
    assert np.abs(ours - resid).max() < 1e-3


# ------------------------------------------- beyond the JAX package's tests


@pytest.mark.parametrize("q", [1.0, 3.0, 7.0])
@pytest.mark.parametrize("plane", ["Y", "CbCr"])
@pytest.mark.parametrize("name", ["lena", "sail"])
def test_wavefront_equals_jax_bit_for_bit(name, plane, q, lena, sail):
    """Residuals, reconstruction and the decoder's inverse, every bit."""
    img = lena if name == "lena" else sail
    ycbcr = np.asarray(j_rgb2ycbcr(img))
    x = np.ascontiguousarray(ycbcr[:, :, 0:1] if plane == "Y" else ycbcr[:, :, 1:3])
    coeffs = COEFFS_Y if plane == "Y" else COEFFS_CBCR
    res, rec = predict_from_neighbors(torch.from_numpy(x), coeffs, q, return_recon=True)
    jres, jrec = jwave.predict_from_neighbors(x, coeffs, q, return_recon=True)
    assert_exact(_bits(res), _bits(jres), "residuals (bits)")
    assert_exact(_bits(rec), _bits(jrec), "reconstruction (bits)")
    first_row, first_col = x[0], x[:, 0]
    if plane == "Y":
        first_row, first_col = first_row[:, 0], first_col[:, 0]
    inv = reconstruct_from_residual(res, first_row, first_col, coeffs, q)
    assert_exact(_bits(inv), _bits(jwave.reconstruct_from_residual(
        np.asarray(jres), first_row, first_col, coeffs, q)), "inverse (bits)")
    assert_exact(_bits(inv), _bits(rec), "the decoder rebuilds the encoder's reconstruction")


@pytest.mark.parametrize("q", [1.0, 3.0])
@pytest.mark.parametrize("shape", [(1, 7, 1), (7, 1, 2), (2, 2, 1), (3, 17, 3), (33, 5, 2),
                                   (20, 31, 1)])
def test_wavefront_on_thin_frames_equals_jax(shape, q):
    """Frames of one row or column (no interior), and widths that are not a
    multiple of the vector width: still every bit."""
    x = (np.random.default_rng(sum(shape)).random(shape) * 255).astype(np.float32)
    res, rec = predict_from_neighbors(x, COEFFS_Y, q, return_recon=True)
    jres, jrec = jwave.predict_from_neighbors(x, COEFFS_Y, q, return_recon=True)
    assert res.shape == np.asarray(jres).shape
    assert_exact(_bits(res), _bits(jres), "residuals (bits)")
    assert_exact(_bits(rec), _bits(jrec), "reconstruction (bits)")


@pytest.mark.parametrize("name", ["lena", "sail"])
def test_min_entropy_predictor_matches_jax(name, lena, sail):
    img = lena if name == "lena" else sail
    for plane in (img[:, :, 0], img[:, :, 1:2], img.mean(axis=-1).astype(np.uint8)):
        res, pred = min_entropy_predictor(plane, device="cpu")
        jres, jp = jpred.min_entropy_predictor(plane)
        assert res.dtype == torch.int32 and tuple(res.shape) == (img.shape[0] * img.shape[1],)
        assert_exact(res, jres, "residuals")
        assert_exact(pred, jp, "prediction")


@pytest.mark.parametrize("q", [1.0, 4.0])
@pytest.mark.parametrize("subsample", [False, True])
@pytest.mark.parametrize("name", ["lena", "sail"])
def test_predictive_codec_matches_jax(name, subsample, q, lena, sail):
    img = lena if name == "lena" else sail
    codec = PredictiveCodec(q, subsample_chroma=subsample, device="cpu")
    rec, bits, bpp = codec.encode_decode(img, return_bpp=True)
    jcodec = JPredictive(q, subsample_chroma=subsample)
    jrec, jbits, jbpp = jcodec.encode_decode(img, return_bpp=True)
    assert rec.dtype == torch.uint8 and tuple(rec.shape) == img.shape
    assert bpp == bits / (img.shape[0] * img.shape[1])
    (res_y, _, _), (res_c, _, _) = codec._residuals(img)
    (jres_y, _, _), (jres_c, _, _) = jcodec._residuals(img)
    assert_exact(res_y, jres_y, "luma residuals")
    psnr, jpsnr = float(calc_psnr(img, rec)), float(calc_psnr(img, jrec))
    if not subsample:
        assert bits == jbits
        assert_exact(res_c, jres_c, "chroma residuals")
        assert_exact(rec, jrec, "RGB")
        assert_exact(codec.huffman.code.lengths, jcodec.huffman.code.lengths, "code lengths")
        return
    n = int((to_numpy(res_c) != np.asarray(jres_c)).sum())
    print(f"{name} q={q}: {n} of {res_c.numel()} chroma residuals differ; bits {bits} vs JAX "
          f"{jbits}; PSNR {psnr:.4f} vs {jpsnr:.4f} dB")
    assert n <= 0.02 * res_c.numel()  # measured: 14, 62, 1,718 and 473
    assert abs(bits - jbits) <= BITS_SHARE * jbits
    assert abs(psnr - jpsnr) <= PSNR_TOL


def test_huffman_helpers_match_jax(lena_small):
    coder, res_y, res_c = thelp.train_huffman(lena_small, device="cpu")
    jcoder, jres_y, jres_c = jhelp.train_huffman(lena_small)
    assert_exact(res_y, jres_y, "Y residuals")
    assert_exact(res_c, jres_c, "CbCr residuals")
    assert coder.lower_bound == jcoder.lower_bound
    assert_exact(coder.code.lengths, jcoder.code.lengths, "code lengths")
    words, bitrate, stream_bits, shape = thelp.huffman_encoding(res_y, coder)
    jwords, jbitrate, jstream_bits, jshape = jhelp.huffman_encoding(jres_y, jcoder)
    assert_exact(words, jwords, "words")
    assert (bitrate, stream_bits, tuple(shape)) == (jbitrate, jstream_bits, tuple(jshape))
    planes = [res_y, res_c[:, :, 0], res_c[:, :, 1]]
    streams, rates, total, shapes = thelp.huffman_encoding(planes, coder)
    jstreams, jrates, jtotal, jshapes = jhelp.huffman_encoding(
        [jres_y, jres_c[:, :, 0], jres_c[:, :, 1]], jcoder)
    for s, js in zip(streams, jstreams):
        assert_exact(s, js, "plane words")
    assert (rates, total) == (jrates, jtotal)
    assert [tuple(s) for s in shapes] == [tuple(s) for s in jshapes]
