"""The port's L0-L2 public API against the JAX package: the separable DCT
facade, the quantizer, zig-zag and patching, padding, the config
dataclasses, fixtures, image I/O and the headless plots, and the package
exports.

Inputs are numpy arrays from the fixtures or fixed seeds, given to both
packages on the CPU. Integers (quantized symbols, layouts, indices) must be
equal. The separable DCT is two float32 matrix products, which torch and
XLA sum in other orders: DCT_SEP_TOL = 1e-3 on coefficients up to 2,040
(a few ulp; 2.4e-4 measured on satpic1).
"""

import dataclasses
import os

import numpy as np
import pytest
import scipy.fft as sfft
import torch

from torch_parity import assert_close, assert_exact

import ivclab_tpu
import ivclab_tpu.config as jconfig
import ivclab_tpu.entropy as jentropy
import ivclab_tpu.models as jmodels
import ivclab_tpu.ops as jops
import ivclab_tpu.runtime as jruntime
import ivclab_tpu.utils as jutils
from ivclab_tpu.ops import dct as jdct, quant as jquant
from ivclab_tpu.utils import fixtures as jfix, shape as jshape

import ivclab_tpu_torch
import ivclab_tpu_torch.config as tconfig
import ivclab_tpu_torch.entropy as tentropy
import ivclab_tpu_torch.models as tmodels
import ivclab_tpu_torch.ops as tops
import ivclab_tpu_torch.runtime as truntime
import ivclab_tpu_torch.utils as tutils
from ivclab_tpu_torch.ops.dct import (
    DiscreteCosineTransform,
    dct2,
    dct2_fused,
    idct2,
    idct2_fused,
    zigzag_scan,
)
from ivclab_tpu_torch.ops.quant import (
    PatchQuant,
    dequantize_flat,
    quant_table_zigzag,
    quant_tables,
    quantize_flat,
)
from ivclab_tpu_torch.utils import Patcher, ZigZag, calc_mse, fixtures as tfix, huffman_helpers
from ivclab_tpu_torch.utils.shape import (
    pad_to_block_multiple,
    zigzag_gather_indices,
    zigzag_scatter_indices,
)

DCT_SEP_TOL = 1e-3


# --------------------------------------- twins of tests/test_ch3_dct_quant.py


def test_dct_matches_scipy_and_jax():
    x = (np.random.default_rng(13).random((6, 7, 3, 8, 8)) * 255).astype(np.float32)
    ref = sfft.dct(sfft.dct(x, axis=-1, norm="ortho"), axis=-2, norm="ortho")
    ours = dct2(x)
    assert np.abs(ours.numpy() - ref).max() < 2e-2
    assert_close(ours, jdct.dct2(x), DCT_SEP_TOL, "dct2 vs JAX")
    assert_close(idct2(ours), jdct.idct2(ours.numpy()), DCT_SEP_TOL, "idct2 vs JAX")
    facade = DiscreteCosineTransform()
    assert torch.equal(facade.transform(x), ours)
    assert torch.equal(facade.inverse_transform(ours), idct2(ours))
    with pytest.raises(NotImplementedError):
        DiscreteCosineTransform(norm="forward")


def test_idct_roundtrip_allclose(satpic1):
    patched = Patcher().patch(satpic1).to(torch.float32)
    rec = idct2(dct2(patched))
    assert torch.allclose(rec, patched, atol=1e-2)


def test_fused_equals_separable():
    x = (np.random.default_rng(14).random((50, 64)) * 255).astype(np.float32)
    sep = dct2(x.reshape(50, 8, 8)).reshape(50, 64)[:, torch.from_numpy(
        zigzag_gather_indices(8).astype(np.int64))]
    fused = dct2_fused(torch.from_numpy(x))
    assert float((fused - sep).abs().max()) < 2e-2
    assert float((idct2_fused(fused) - torch.from_numpy(x)).abs().max()) < 2e-2


def test_dct_energy_golden(satpic1):
    patched = Patcher().patch(satpic1).to(torch.float32)
    energy = float((dct2(patched).double() ** 2).mean())
    # Parseval: energy preserved by the orthonormal transform
    assert abs(energy - float((patched.double() ** 2).mean())) / energy < 1e-5
    assert abs(energy - 17048.0) < 100


def test_quantization_golden(satpic1):
    patched = Patcher().patch(satpic1)
    quantized = PatchQuant(quantization_scale=1.0).quantize(patched)
    assert quantized.dtype == torch.int32
    assert_exact(quantized, jquant.PatchQuant(1.0).quantize(jshape.Patcher().patch(satpic1)),
                 "symbols vs JAX")
    assert abs(float((quantized.double() ** 2).mean()) - 14.3108) < 0.1


def test_quant_roundtrip_mse_golden(satpic1):
    patcher = Patcher()
    q = PatchQuant(quantization_scale=1.0)
    deq = q.dequantize(q.quantize(patcher.patch(satpic1)))
    recon = patcher.unpatch(deq)
    jq = jquant.PatchQuant(1.0)
    jp = jshape.Patcher()
    assert_exact(recon, jp.unpatch(jq.dequantize(jq.quantize(jp.patch(satpic1)))), "vs JAX")
    assert abs(float(calc_mse(satpic1, recon)) - 552.8058) < 5


def test_quant_rounding_half_even():
    """np.round semantics (half to even)."""
    coeffs = np.zeros((1, 1, 3, 8, 8), np.float32)
    coeffs[0, 0, 0, 0, 0] = 24.0  # 24/16 = 1.5 -> 2
    coeffs[0, 0, 0, 0, 1] = 5.5  # 5.5/11 = 0.5 -> 0
    out = PatchQuant(quantization_scale=1.0).quantize(coeffs)
    assert int(out[0, 0, 0, 0, 0]) == 2
    assert int(out[0, 0, 0, 0, 1]) == 0


def test_dequantize_truncates():
    """Dequantization casts toward zero to int32, as the reference does."""
    q = PatchQuant(quantization_scale=0.15)
    sym = np.full((1, 1, 3, 8, 8), 3, np.int32)
    out = q.dequantize(sym).numpy()
    assert np.array_equal(out[0, 0], (3 * q.get_quantization_table()).astype(np.int32))
    assert_exact(out, jquant.PatchQuant(0.15).dequantize(sym), "vs JAX")


def test_zigzag_facade_roundtrip():
    z = ZigZag()
    x = np.random.default_rng(15).integers(-50, 50, size=(4, 5, 3, 8, 8)).astype(np.int32)
    flat = z.flatten(x)
    assert tuple(flat.shape) == (4, 5, 3, 64)
    assert_exact(flat, jshape.ZigZag().flatten(x), "flatten vs JAX")
    assert_exact(z.unflatten(flat), x, "round trip")
    assert_exact(zigzag_scan(x), jdct.zigzag_scan(x), "zigzag_scan vs JAX")
    with pytest.raises(ValueError):
        zigzag_scan(np.zeros((8, 4)))


def test_quant_table_zigzag_consistency():
    tables = PatchQuant(1.0).get_quantization_table().reshape(3, 64)
    assert np.array_equal(quant_table_zigzag(1.0, 3), tables[:, zigzag_gather_indices(8)])
    lum = np.arange(1, 65, dtype=np.float32).reshape(8, 8)
    chrom = lum[::-1].copy()
    assert np.array_equal(quant_tables(2, lum, chrom), jquant.quant_tables(2, lum, chrom))
    assert np.array_equal(quant_table_zigzag(0.5, 3, lum, chrom),
                          jquant.quant_table_zigzag(0.5, 3, lum, chrom))
    assert np.array_equal(PatchQuant(2.0, lum, chrom).get_quantization_table(),
                          jquant.PatchQuant(2.0, lum, chrom).get_quantization_table())


# ------------------------------------------- beyond the JAX package's tests


def test_flat_quantizers_match_jax():
    """The same scan-ordered coefficients give the same symbols and levels."""
    coeffs = (np.random.default_rng(16).normal(0, 60, (40, 3, 64))).astype(np.float32)
    coeffs[0, 0, :4] = [24.0, 5.5, -8.0, 0.5]  # ties at k + 1/2 after scaling
    table = quant_table_zigzag(0.7, 3)
    sym = quantize_flat(coeffs, table)
    assert sym.dtype == torch.int32
    assert_exact(sym, jquant.quantize_flat(coeffs, table), "quantize_flat")
    assert_exact(dequantize_flat(sym, table), jquant.dequantize_flat(sym.numpy(), table),
                 "dequantize_flat")


@pytest.mark.parametrize("shape", [(16, 24, 3), (24, 16), (8, 8, 1)])
def test_patcher_matches_jax(shape):
    x = np.random.default_rng(17).integers(0, 256, shape).astype(np.uint8)
    p = Patcher().patch(x)
    assert_exact(p, jshape.Patcher().patch(x), "patch")
    back = Patcher().unpatch(p)
    assert_exact(back, x if x.ndim == 3 else x[:, :, None], "unpatch")
    with pytest.raises(ValueError):
        Patcher().patch(np.zeros((12, 16)))


@pytest.mark.parametrize("mode", ["edge", "symmetric", "reflect", "constant"])
def test_pad_to_block_multiple_matches_jax(mode):
    x = np.random.default_rng(18).integers(0, 256, (45, 61, 3)).astype(np.int32)
    ours, hw = pad_to_block_multiple(x, mode=mode)
    ref, jhw = jshape.pad_to_block_multiple(x, mode=mode)
    assert hw == jhw == (45, 61)
    assert_exact(ours, ref, f"pad {mode}")
    same, _ = pad_to_block_multiple(np.zeros((16, 8)))
    assert tuple(same.shape) == (16, 8)


def test_zigzag_tables_match_jax():
    for n in (4, 8):
        assert_exact(zigzag_scatter_indices(n), jshape.zigzag_scatter_indices(n), f"n={n}")
        assert_exact(zigzag_scatter_indices(n)[zigzag_gather_indices(n)], np.arange(n * n),
                     "inverse permutation")


def test_config_matches_jax():
    for name in ("IntraConfig", "VideoConfig", "SweepConfig", "MeshConfig", "Config"):
        assert dataclasses.asdict(getattr(tconfig, name)()) == dataclasses.asdict(
            getattr(jconfig, name)()), name


def test_video_1080p_fixture_matches_jax():
    t, j = tfix.video_1080p(num_frames=2), jfix.video_1080p(num_frames=2)
    assert t.shape == (2, 1088, 1920, 3) and np.array_equal(t, j)


def test_plot_helpers_headless(tmp_path, lena):
    """The course reference's plot helpers, headless: figures render and
    save without a display."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    from ivclab_tpu_torch.entropy import plot_histogram, plot_image_and_joint_histogram
    from ivclab_tpu_torch.entropy.stats import stats_joint
    from ivclab_tpu_torch.ops.color import rgb2gray

    out = tmp_path / "hist.png"
    fig = plot_histogram(lena, title="lena", save_path=str(out))
    assert out.exists() and out.stat().st_size > 0
    assert len(fig.axes) == 4  # image + 3 channels
    fig_gray = plot_histogram(torch.from_numpy(lena), grayscale=True)
    assert len(fig_gray.axes) == 2

    gray = rgb2gray(lena.astype(np.float32))
    pmf = stats_joint(gray, np.arange(257))
    out2 = tmp_path / "joint.png"
    plot_image_and_joint_histogram(gray, pmf, "lena", save_path=str(out2))
    assert out2.exists() and out2.stat().st_size > 0
    import matplotlib.pyplot as plt

    plt.close("all")


def test_write_video_fallback(tmp_path, foreman):
    """mp4 export: with no cv2/imageio installed the PNG-frame fallback
    writes the frames losslessly."""
    from ivclab_tpu_torch.utils.io import imread, imwrite, write_video
    from ivclab_tpu.utils.io import imread as j_imread

    target = str(tmp_path / "clip.mp4")
    out = write_video(target, torch.from_numpy(foreman[:3]), fps=10)
    if out == target:  # a real encoder backend was available
        assert os.path.getsize(target) > 0
        return
    files = sorted(os.listdir(out))
    assert files == ["frame0000.png", "frame0001.png", "frame0002.png"]
    rt = imread(os.path.join(out, files[1]))
    assert np.array_equal(rt, foreman[1])
    assert np.array_equal(j_imread(os.path.join(out, files[1])), rt)
    png = str(tmp_path / "float.png")
    imwrite(png, foreman[0].astype(np.float32) + 0.4)  # rounded and clipped to uint8
    assert np.array_equal(imread(png), foreman[0])


def test_imshow_on_an_axis(lena):
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    from ivclab_tpu_torch import imshow

    fig, axes = plt.subplots(1, 3)
    imshow(axes[0], lena, title="rgb")
    imshow(axes[1], lena[:, :, :1])
    imshow(axes[2], torch.from_numpy(lena[:, :, 0]), hide_ticks=False)
    assert axes[0].get_title() == "rgb" and axes[0].get_xticks().size == 0
    plt.close(fig)


# ------------------------------------------------------------------ exports

_PACKAGES = [
    (ivclab_tpu, ivclab_tpu_torch),
    (jops, tops),
    (jentropy, tentropy),
    (jutils, tutils),
    (jmodels, tmodels),
    (jruntime, truntime),
]


@pytest.mark.parametrize("pair", _PACKAGES, ids=lambda p: p[0].__name__)
def test_exports_cover_the_jax_package(pair):
    """Every name the JAX package exports, where the port has it, is in the
    port's ``__all__`` and importable; none is missing at these levels."""
    jpkg, tpkg = pair
    have = [n for n in jpkg.__all__ if hasattr(tpkg, n)]
    missing = sorted(set(jpkg.__all__) - set(have))
    assert missing == [], f"{tpkg.__name__} lacks {missing}"
    assert set(have) <= set(tpkg.__all__)
    for n in tpkg.__all__:
        assert getattr(tpkg, n) is not None


def test_version_module_equals_jax():
    import ivclab_tpu.version as jversion
    import ivclab_tpu_torch.version as tversion

    assert tversion.__version__ == jversion.__version__ == ivclab_tpu_torch.__version__


def test_pyproject_installs_both_clis():
    """``ivclab-tpu-torch`` runs the port's CLI; ``ivclab-tpu`` stays the
    JAX package's."""
    import importlib
    import tomllib

    root = os.path.dirname(os.path.dirname(__file__))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["ivclab-tpu"] == "ivclab_tpu.cli:main"
    assert scripts["ivclab-tpu-torch"] == "ivclab_tpu_torch.cli:main"
    module, attr = scripts["ivclab-tpu-torch"].split(":")
    assert callable(getattr(importlib.import_module(module), attr))


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    """Every module of the port, as ``pkgutil.walk_packages`` finds it,
    imports without JAX, the JAX package, PIL or matplotlib."""
    import json
    import subprocess
    import sys

    code = ("import importlib, json, pkgutil, sys, ivclab_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(ivclab_tpu_torch.__path__, "
            "'ivclab_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "print(json.dumps([names, [m for m in sys.modules if m.startswith(('jax', "
            "'ivclab_tpu.', 'PIL', 'matplotlib'))]]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    names, foreign = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("ivclab_tpu_torch.cli", "ivclab_tpu_torch.version",
                 "ivclab_tpu_torch.parallel.video",
                 "ivclab_tpu_torch.tools.bench", "ivclab_tpu_torch.tools.scaling",
                 "ivclab_tpu_torch.tools.motion_ab", "ivclab_tpu_torch.tools.walk_ab",
                 "ivclab_tpu_torch.examples.ch4_video"):
        assert name in names
    assert foreign == []


_DEFAULT_CUDA = {
    "yuv420compression": lambda img: ivclab_tpu_torch.yuv420compression(img),
    "ict_compression": lambda img: ivclab_tpu_torch.ict_compression(img),
    "FilterPipeline": lambda img: ivclab_tpu_torch.FilterPipeline().filter_img(img),
    "PredictiveCodec": lambda img: ivclab_tpu_torch.PredictiveCodec().encode_decode(img),
    "single_pixel_predictor": lambda img: ivclab_tpu_torch.single_pixel_predictor(img),
    "min_entropy_predictor": lambda img: ivclab_tpu_torch.min_entropy_predictor(img[:, :, 0]),
    "three_pixels_predictor": lambda img: ivclab_tpu_torch.three_pixels_predictor(img),
    "train_huffman": lambda img: huffman_helpers.train_huffman(img),
}


@pytest.mark.parametrize("entry", sorted(_DEFAULT_CUDA))
def test_new_entry_points_default_to_the_card(entry):
    """Without a device argument each runs on CUDA; on a machine without a
    card it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the default runs there")
    img = np.random.default_rng(19).integers(0, 256, (16, 16, 3)).astype(np.uint8)
    with pytest.raises((RuntimeError, AssertionError)):
        _DEFAULT_CUDA[entry](img)
