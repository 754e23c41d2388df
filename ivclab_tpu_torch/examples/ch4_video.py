"""Chapter-4-style video codec studies: RD sweeps over codebook policies,
intra-vs-video comparison, and optional frame export.

Twin of the repository's ``examples/ch4_video.py`` (the course's
``exercises/ch4``: ``E4-1.py:354-405``, ``ex1.py:377-450``): foreman-class
frames, search range 4, the three codec variants (fixed / first-P-frame /
per-frame-adaptive codebooks), the intra-codec-as-video baseline, and the
reconstructions written as PNG frames and a GIF (``--export``, which needs
PIL). On the card every P-frame of the video sweeps launches the
motion-search kernel once.

Run: python3 -m ivclab_tpu_torch.examples.ch4_video [--device cuda|cpu]
     [--frames 8] [--quick] [--export dir]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ivclab_tpu_torch import IntraCodec, VideoCodec, calc_psnr
from ivclab_tpu_torch.config import SweepConfig
from ivclab_tpu_torch.utils import fixtures


def rd_point(codec, frames):
    psnrs, bits = [], []
    for t in range(frames.shape[0]):
        recon, _, b = codec.encode_decode(frames[t], frame_num=t)
        psnrs.append(float(calc_psnr(frames[t], recon)))
        bits.append(b)
    bpp = float(np.mean(bits)) / (frames[0].size / 3)
    return bpp, float(np.mean(psnrs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--quick", action="store_true", help="3 q-scales only")
    ap.add_argument("--export", default=None, help="directory for recon frames")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    frames = fixtures.video("foreman", num_frames=args.frames)
    sweep = SweepConfig()
    q_video = sweep.video_q_scales[::4] if args.quick else sweep.video_q_scales
    q_image = sweep.image_vs_video_q_scales[::4] if args.quick else sweep.image_vs_video_q_scales

    # the three ch4 codec variants, collapsed into codebook_policy
    for policy in ("per-frame", "first-p-frame", "adaptive"):
        print(f"video RD sweep — codebook_policy={policy}:")
        for q in q_video:
            codec = VideoCodec(quantization_scale=q, codebook_policy=policy, device=dev)
            bpp, psnr = rd_point(codec, frames)
            print(f"  q={q:<4}: bpp={bpp:.4f}  PSNR={psnr:.2f} dB")

    # intra-codec-as-video baseline (exercises/ch4/ex1.py:423-450)
    print("intra-per-frame baseline:")
    for q in q_image:
        codec = IntraCodec(quantization_scale=q, device=dev)
        codec.train_huffman_from_image(frames[0])
        psnrs, bits = [], []
        for t in range(frames.shape[0]):
            recon, _, bitsize, _ = codec.encode_decode(frames[t], return_bpp=True)
            psnrs.append(float(calc_psnr(frames[t], recon)))
            bits.append(bitsize)
        bpp = float(np.mean(bits)) / (frames[0].size / 3)
        print(f"  q={q:<4}: bpp={bpp:.4f}  PSNR={float(np.mean(psnrs)):.2f} dB")

    if args.export:
        import pathlib

        from PIL import Image  # the frame writes need it too: a missing PIL fails here

        from ivclab_tpu_torch.utils.io import imwrite

        outdir = pathlib.Path(args.export)
        outdir.mkdir(parents=True, exist_ok=True)
        codec = VideoCodec(quantization_scale=1.0, device=dev)
        recons, _ = codec.encode_decode_sequence(frames)
        recons = recons.cpu().numpy()
        for t in range(recons.shape[0]):
            imwrite(str(outdir / f"recon_{t:04d}.png"), recons[t])
        imgs = [Image.fromarray(r) for r in recons]
        imgs[0].save(outdir / "recon.gif", save_all=True, append_images=imgs[1:], duration=100,
                     loop=0)
        print(f"wrote {outdir}/recon.gif + {recons.shape[0]} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
