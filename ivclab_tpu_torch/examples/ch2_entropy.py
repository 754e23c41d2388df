"""Chapter-2-style entropy studies and the DPCM codec RD sweep.

Twin of the repository's ``examples/ch2_entropy.py`` (the course's
``exercises/ch2``): marginal/joint/conditional entropies, predictor
residual entropies, common-codebook cross-entropy, Huffman coding of
min-entropy predictor residuals, and the full 3-pixel-predictor DPCM codec
swept over quantization steps (``ex_final_codec.py:57-102``). The
statistics run on ``--device``; the Huffman coders are host code.

Run: python3 -m ivclab_tpu_torch.examples.ch2_entropy [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ivclab_tpu_torch import (
    HuffmanCoder,
    PredictiveCodec,
    calc_entropy,
    calc_psnr,
    min_code_length,
    min_entropy_predictor,
    rgb2gray,
    single_pixel_predictor,
    smooth_pmf,
    stats_cond,
    stats_joint,
    stats_marg,
    three_pixels_predictor,
)
from ivclab_tpu_torch.config import SweepConfig
from ivclab_tpu_torch.utils import fixtures
from ivclab_tpu_torch.utils.huffman_helpers import huffman_encoding, train_huffman


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    names = ["lena", "sail", "peppers"]
    images = {n: fixtures.image(n) for n in names}
    on_dev = {n: torch.as_tensor(img, device=dev) for n, img in images.items()}
    rng = np.arange(256)

    # ex1-4: marginal / joint / conditional entropies
    pmfs = {}
    for n, img in on_dev.items():
        pmfs[n] = stats_marg(img, rng)
        h = float(calc_entropy(pmfs[n]))
        hj = float(calc_entropy(stats_joint(img, rng)))
        hc = float(stats_cond(img, rng))
        print(f"{n}: H={h:.4f}  H_joint={hj:.4f}  H_cond={hc:.4f} bits")

    # common-codebook cross-entropy (ex_comparison.py), the mean on the host
    common = np.mean([p.cpu().numpy() for p in pmfs.values()], axis=0)
    for n in names:
        cl = float(min_code_length(pmfs[n], torch.from_numpy(common)))
        print(f"{n}: min code length under common pmf = {cl:.4f} bits")

    # ex5/ex6: predictor residual entropies
    sail = images["sail"]
    res1 = single_pixel_predictor(sail, device=dev)
    h1 = float(calc_entropy(stats_marg(res1, np.arange(-255, 255))))
    ry, rc = three_pixels_predictor(sail, device=dev)
    merged = torch.cat([ry.reshape(-1), rc.reshape(-1)])
    h3 = float(calc_entropy(stats_marg(merged, np.arange(-255, 255))))
    print(f"predictor entropies: single={h1:.4f}  three-pixel={h3:.4f} bits")

    # ex_huffcoder: Huffman on the min-entropy (LOCO-I/median) predictor
    # residuals (exercises/ch2/ex_huffcoder.py:76-116 workload)
    gray = rgb2gray(on_dev["lena"]).to(torch.int32)
    res, _ = min_entropy_predictor(gray, device=dev)
    res_pmf = stats_marg(res, np.arange(-255, 257))
    h_me = float(calc_entropy(res_pmf))
    coder_me = HuffmanCoder(lower_bound=-255).train(
        np.asarray(smooth_pmf(res_pmf), dtype=np.float64)
    )
    _, me_bits = coder_me.encode(res.cpu().numpy())
    print(
        f"min-entropy predictor: residual entropy={h_me:.4f} bits, "
        f"huffman rate={me_bits / res.numel():.4f} bpp"
    )

    # my_utils parity helper: Huffman on three-pixel residuals
    coder, res_y, res_cbcr = train_huffman(images["lena"], device=dev)
    streams, bitrates, total_bits, shapes = huffman_encoding(
        [res_y, res_cbcr[:, :, 0], res_cbcr[:, :, 1]], coder
    )
    n_px = images["lena"].shape[0] * images["lena"].shape[1]
    print(
        f"huffman on residuals: {total_bits} stream bits, "
        f"{sum(bitrates) / n_px:.4f} payload bpp, prefix-free={coder.is_prefix_free()}"
    )

    # ex_final_codec: DPCM codec RD sweep
    lena = images["lena"]
    print("DPCM codec RD sweep (3-pixel predictor + chroma subsample):")
    for q in SweepConfig().dpcm_quant_steps:
        recon, _, bpp = PredictiveCodec(quant_step=float(q), device=dev).encode_decode(
            lena, return_bpp=True)
        print(f"  q={q:3d}: bpp={bpp:.4f}  PSNR={float(calc_psnr(lena, recon)):.2f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
