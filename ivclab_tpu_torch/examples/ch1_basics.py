"""Chapter-1-style basics: color, metrics, filtering, sampling, YUV 4:2:0.

Twin of the repository's ``examples/ch1_basics.py`` (the course's
``exercises/ch1/ex1.py``-``exE.py``, ``ex_ict*.py``, ``ex_aliasing.py``):
grayscale conversion, PSNR of degraded pairs, the filter/decimate
pipelines, aliasing study via FFT spectra, and the ICT + chroma
subsampling codec comparison. The planes are processed on ``--device``;
the spectra are numpy on a host copy, as in the JAX example.

Run: python3 -m ivclab_tpu_torch.examples.ch1_basics [--device cuda|cpu] [--plot out_dir]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ivclab_tpu_torch import (
    FilterPipeline,
    calc_mse,
    calc_psnr,
    ict_compression,
    imshow,
    rgb2gray,
    yuv420compression,
)
from ivclab_tpu_torch.ops.resample import (
    decimate,
    downsample,
    fft_resample,
    interpolation_upsample,
    lowpass_filter,
    upsample,
)
from ivclab_tpu_torch.utils import fixtures

LOWPASS_KERNEL = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float64)


def method_comparison(images=("lena", "monarch", "sail", "smandril", "peppers"),
                      device: str | torch.device = "cuda"):
    """PSNR-vs-nominal-rate comparison of the ch1 compression schemes.

    Reference parity: ``exercises/ch1/ex_comparison.py:21-52``: the four
    ``exE.py`` pipeline variants (lowpass prefilter / stride-2 downsample /
    bilinear upsample / lowpass postfilter combinations) plus the ICT
    chroma-subsampling codec, evaluated per image and averaged. Rates are
    the exercise's nominal bpp charges (6 bpp for the spatially downsampled
    methods, 12 bpp for ICT), not entropy-coded sizes.
    """
    def to_u8(x):  # torch.round rounds half to even, as jnp.round does
        return torch.round(x).clamp(0, 255).to(torch.uint8)

    def down_up(x):
        return interpolation_upsample(downsample(x.to(torch.float32)))

    methods = {
        # exE.py codec: lowpass -> downsample -> bilinear upsample
        "codec": lambda img: to_u8(down_up(lowpass_filter(img, LOWPASS_KERNEL))),
        # exE.py codec_postfiltering: codec + lowpass postfilter
        "codec_postfiltering": lambda img: to_u8(
            lowpass_filter(down_up(lowpass_filter(img, LOWPASS_KERNEL)), LOWPASS_KERNEL)
        ),
        # exE.py subsampling: no prefilter
        "subsampling": lambda img: to_u8(down_up(img)),
        # exE.py subsampling_postfiltering
        "subsampling_postfiltering": lambda img: to_u8(
            lowpass_filter(down_up(img), LOWPASS_KERNEL)
        ),
        # ex_ict.py codec_ict
        "codec_ict": lambda img: ict_compression(img, chroma_mode="fft", device=device),
    }
    bpp = {name: (12.0 if name == "codec_ict" else 6.0) for name in methods}

    per_image = {}
    for name in images:
        img = torch.as_tensor(fixtures.image(name), device=device)
        per_image[name] = {
            m: (bpp[m], float(calc_psnr(img, fn(img)))) for m, fn in methods.items()
        }
    mean = {
        m: (
            bpp[m],
            float(np.mean([per_image[n][m][1] for n in images])),
        )
        for m in methods
    }
    return {"per_image": per_image, "mean": mean}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plot", default=None, help="directory for output PNGs")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    lena = fixtures.image("lena")
    lena_rec = fixtures.degraded("lena")
    sail = fixtures.image("sail")
    lena_t = torch.as_tensor(lena, device=dev)

    # ex1: grayscale conversion
    gray = rgb2gray(lena_t).cpu().numpy()
    print(f"rgb2gray: shape={gray.shape} mean={gray.mean():.2f}")

    # ex2: PSNR of a precompressed pair
    lena_rec_t = torch.as_tensor(lena_rec, device=dev)
    print(f"MSE(lena, lena_rec)  = {float(calc_mse(lena_t, lena_rec_t)):.4f}")
    print(f"PSNR(lena, lena_rec) = {float(calc_psnr(lena_t, lena_rec_t)):.4f} dB")

    # ex3: filter pipeline (prefilter -> decimate -> resample -> postfilter)
    pipe = FilterPipeline(device=dev)
    for prefilter in (True, False):
        out = pipe.filter_img(lena, prefilter=prefilter)
        print(f"filter pipeline prefilter={prefilter}: PSNR={float(calc_psnr(lena, out)):.2f} dB")

    # ex4: YUV 4:2:0 chroma subsampling codec
    for name, img in (("lena", lena), ("sail", sail)):
        rec = yuv420compression(img, device=dev)
        print(f"yuv420 {name}: PSNR={float(calc_psnr(img, rec)):.2f} dB")

    # aliasing study: naive downsample vs anti-aliased decimate, spectra
    y = rgb2gray(lena_t)[:, :, 0]
    naive = downsample(y).cpu().numpy()
    aa_t = decimate(decimate(y, 2, axis=0), 2, axis=1)
    aa = aa_t.cpu().numpy()
    spec = lambda p: np.log1p(np.abs(np.fft.fftshift(np.fft.fft2(p))))  # noqa: E731
    e_naive = float(spec(naive)[: naive.shape[0] // 4].mean())
    e_aa = float(spec(aa)[: aa.shape[0] // 4].mean())
    print(f"aliasing: high-band spectral energy naive={e_naive:.3f} vs anti-aliased={e_aa:.3f}")

    # sampling: zero-insertion vs bilinear vs FFT upsampling of the decimated plane
    up0 = upsample(aa_t)
    up1 = interpolation_upsample(aa_t)
    up2 = fft_resample(fft_resample(aa_t, y.shape[0], axis=0), y.shape[1], axis=1)
    for name, up in (("zero-insert", up0), ("bilinear", up1), ("fft", up2)):
        print(f"upsample {name}: PSNR={float(calc_psnr(y, up)):.2f} dB")

    # ICT codec study (exercises/ch1/ex_ict.py, ex_ict_decimate.py): ICT
    # color transform + 4:2:0 chroma subsampling, FFT vs FIR chroma paths
    for mode in ("fft", "fir"):
        rec = ict_compression(sail, chroma_mode=mode, device=dev)
        print(f"ict ({mode} chroma) sail: PSNR={float(calc_psnr(sail, rec)):.2f} dB")

    # method comparison (exercises/ch1/ex_comparison.py): every ch1
    # compression scheme on the five comparison images, with the exercise's
    # nominal rate accounting (downsampled x2 both dims -> 3*8/4 = 6 bpp;
    # ICT keeps Y full resolution -> 8*(1 + 2/4) = 12 bpp)
    comparison = method_comparison(device=dev)
    print("\nmethod comparison (mean over lena/monarch/sail/smandril/peppers):")
    print(f"  {'method':<26} {'bpp':>5} {'mean PSNR dB':>12}")
    for method, (bpp, psnr) in comparison["mean"].items():
        print(f"  {method:<26} {bpp:>5.1f} {psnr:>12.2f}")

    if args.plot:
        import pathlib

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        outdir = pathlib.Path(args.plot)
        outdir.mkdir(parents=True, exist_ok=True)
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        imshow(axes[0], lena, "original")
        imshow(axes[1], yuv420compression(lena, device=dev), "yuv420")
        imshow(axes[2], pipe.filter_img(lena), "filter pipeline")
        fig.savefig(outdir / "ch1_basics.png", dpi=90)
        plt.close(fig)
        print(f"wrote {outdir/'ch1_basics.png'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
