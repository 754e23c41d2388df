"""Chapter-3-style intra codec studies: manual pipeline, coefficient
dropping, and the canonical image RD sweep.

Twin of the repository's ``examples/ch3_intra.py`` (the course's
``exercises/ch3``: ``E3-1.py``, ``K3-1.py``, ``ex1.py:21-51``: train
Huffman on lena_small, code lena over q in {0.05, 0.1, 0.15, 0.2, 0.3}).

Run: python3 -m ivclab_tpu_torch.examples.ch3_intra [--device cuda|cpu] [--plot out_dir]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ivclab_tpu_torch import IntraCodec, ZigZag, calc_psnr, rgb2gray
from ivclab_tpu_torch.config import SweepConfig
from ivclab_tpu_torch.ops.dct import dct2, idct2
from ivclab_tpu_torch.utils import Patcher, fixtures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plot", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    lena = fixtures.image("lena")
    lena_small = fixtures.image("lena_small")

    # E3-1: manual pipeline walk with symbol statistics
    codec = IntraCodec(quantization_scale=1.0, device=dev)
    symbols = codec.image2symbols(lena_small)
    uniq = np.unique(symbols)
    print(f"manual pipeline: {symbols.size} symbols, {uniq.size} unique, "
          f"range [{symbols.min()}, {symbols.max()}]")
    recon = codec.symbols2image(symbols, lena_small.shape)
    print(f"  round trip PSNR = {float(calc_psnr(lena_small, recon)):.2f} dB")

    # K3-1: full-image DCT coefficient-dropping study (K3-1.py:17-39):
    # zero the top-|magnitude| 1/5/10% of whole-image DCT coefficients and
    # measure the PSNR collapse. JAX's argsort is stable, and so must this
    # one be: ties among equal magnitudes would otherwise drop others.
    gray = rgb2gray(torch.as_tensor(lena, device=dev))[:, :, 0]
    full_coeffs = dct2(gray)
    order = torch.argsort(-full_coeffs.abs().reshape(-1), stable=True)
    for perc in (0.01, 0.05, 0.10):
        n_drop = int(perc * full_coeffs.numel())
        dropped = full_coeffs.reshape(-1).clone()
        dropped[order[:n_drop]] = 0.0
        rec = idct2(dropped.reshape(full_coeffs.shape)).clamp(0, 255)
        psnr = float(calc_psnr(gray, rec))
        print(f"drop top {int(perc * 100):2d}% |DCT| coefficients: PSNR = {psnr:.2f} dB")

    # zig-zag retention variant: keep only the first k scan coefficients
    patcher = Patcher()
    patched = patcher.patch(torch.as_tensor(lena_small, device=dev)).to(torch.float32)
    coeffs = dct2(patched)
    zz = ZigZag()
    flat = zz.flatten(coeffs)
    for keep in (1, 4, 16, 32, 64):
        mask = torch.arange(64, device=dev) < keep
        rec = patcher.unpatch(idct2(zz.unflatten(flat * mask)))
        psnr = float(calc_psnr(lena_small, rec.clamp(0, 255)))
        print(f"keep {keep:2d}/64 coefficients: PSNR = {psnr:.2f} dB")

    # ex1: canonical RD sweep: train on lena_small, code lena
    points = []
    for q in SweepConfig().image_q_scales:
        c = IntraCodec(quantization_scale=q, device=dev)
        c.train_huffman_from_image(lena_small)
        recon, _, _, bpp = c.encode_decode(lena, return_bpp=True)
        psnr = float(calc_psnr(lena, recon))
        points.append((q, bpp, psnr))
        print(f"q={q:<5}: bpp={bpp:.4f}  PSNR={psnr:.2f} dB")

    if args.plot:
        import pathlib

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        outdir = pathlib.Path(args.plot)
        outdir.mkdir(parents=True, exist_ok=True)
        plt.figure()
        plt.plot([p[1] for p in points], [p[2] for p in points], "o-")
        plt.xlabel("bpp")
        plt.ylabel("PSNR [dB]")
        plt.title("Intra codec RD curve (train lena_small, code lena)")
        plt.grid(True)
        plt.savefig(outdir / "ch3_rd_curve.png", dpi=90)
        plt.close()
        print(f"wrote {outdir/'ch3_rd_curve.png'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
