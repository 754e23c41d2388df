"""Predictive (DPCM) still-image codec with in-loop residual quantization.

Port of ``ivclab_tpu/models/dpcm.py``, the course's ch2 DPCM codec: the
3-pixel closed-loop predictor, optional 4:2:0 chroma subsampling (the FIR
decimate) and a per-image Huffman code over the residuals. The closed
loop runs as the wavefront of ``ops/predictive.py`` on the codec's device;
the decoder rebuilds from the residuals and the verbatim first row and
column. The residual histogram comes to the host once, where the code is
trained (``HuffmanCoder``) and the rate is the histogram weighted by the
code lengths: the bits the course reference's encoder writes.
"""

from __future__ import annotations

import numpy as np
import torch

from ivclab_tpu_torch.entropy.huffman import HuffmanCoder
from ivclab_tpu_torch.entropy.stats import smooth_pmf
from ivclab_tpu_torch.models.intracodec import bucket_bounds
from ivclab_tpu_torch.models.predictive import COEFFS_CBCR, COEFFS_Y
from ivclab_tpu_torch.ops.color import _f32, rgb2ycbcr, ycbcr2rgb
from ivclab_tpu_torch.ops.predictive import predict_from_neighbors, reconstruct_from_residual
from ivclab_tpu_torch.ops.resample import decimate, fft_resample


class PredictiveCodec:
    """3-pixel DPCM codec: ``encode_decode`` -> (recon RGB uint8, total bits)."""

    def __init__(self, quant_step: float = 1.0, subsample_chroma: bool = True,
                 device: str | torch.device = "cuda"):
        self.quant_step = float(quant_step)
        self.subsample_chroma = bool(subsample_chroma)
        self.device = torch.device(device)
        self.huffman: HuffmanCoder | None = None

    def _residuals(self, img_rgb):
        """((res_Y, rec_Y, Y), (res_C, rec_C, CbCr)) of an RGB image."""
        ycbcr = rgb2ycbcr(_f32(img_rgb).to(self.device))
        Y = ycbcr[:, :, 0:1]
        CbCr = ycbcr[:, :, 1:3]
        if self.subsample_chroma:
            CbCr = torch.stack([decimate(decimate(CbCr[:, :, c], 2, axis=0), 2, axis=1)
                                for c in range(2)], dim=-1)
        res_Y, rec_Y = predict_from_neighbors(Y, COEFFS_Y, self.quant_step, return_recon=True)
        res_C, rec_C = predict_from_neighbors(CbCr, COEFFS_CBCR, self.quant_step,
                                              return_recon=True)
        return (res_Y, rec_Y, Y), (res_C, rec_C, CbCr)

    def _train(self, res_Y: torch.Tensor, res_C: torch.Tensor) -> int:
        """Train the residual code on this image; returns its total bits."""
        all_res = torch.cat([res_Y.reshape(-1), res_C.reshape(-1)]).to(torch.int64)
        mn, mx = torch.aminmax(all_res)
        lo, hi = bucket_bounds(int(mn), int(mx), margin=1, bucket=16)
        hist = torch.bincount(all_res - lo, minlength=hi - lo).cpu().numpy()
        pmf = np.asarray(smooth_pmf(hist / hist.sum()), dtype=np.float64)
        self.huffman = HuffmanCoder(lower_bound=lo).train(pmf)
        return int(np.dot(hist, self.huffman.code.lengths.astype(np.int64)))

    def encode_decode(self, img_rgb, return_bpp: bool = False):
        """Code one RGB image; returns (recon uint8 tensor on the codec's
        device, total bits[, bits per pixel])."""
        H, W = img_rgb.shape[:2]
        (res_Y, _, Y), (res_C, _, CbCr) = self._residuals(img_rgb)
        total_bits = self._train(res_Y, res_C)

        # the decoder side: rebuild from the residuals and the verbatim borders
        recon_Y = reconstruct_from_residual(res_Y, Y[0, :, :], Y[:, 0, :], COEFFS_Y,
                                            self.quant_step)
        recon_C = reconstruct_from_residual(res_C, CbCr[0, :, :], CbCr[:, 0, :], COEFFS_CBCR,
                                            self.quant_step)
        if self.subsample_chroma:
            recon_C = torch.stack([fft_resample(fft_resample(recon_C[:, :, c], H, axis=0), W,
                                                axis=1) for c in range(2)], dim=-1)
        ycbcr = torch.cat([recon_Y[:, :, None], recon_C], dim=-1)
        recon = torch.round(ycbcr2rgb(ycbcr)).clamp(0, 255).to(torch.uint8)
        if return_bpp:
            return recon, total_bits, total_bits / (H * W)
        return recon, total_bits
