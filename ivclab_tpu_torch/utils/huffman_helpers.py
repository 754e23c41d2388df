"""Residual-coding helpers (the course reference's ``my_utils/huffman.py``).

Port of ``ivclab_tpu/utils/huffman_helpers.py``: train a Huffman coder on
3-pixel-predictor residuals (chroma subsampled) and encode one or several
residual planes, counting stream words. The predictor runs on ``device``;
the histogram and the coder are on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ivclab_tpu_torch.entropy.huffman import HuffmanCoder
from ivclab_tpu_torch.models.predictive import three_pixels_predictor
from ivclab_tpu_torch.utils.io import _host


def train_huffman(img_rgb, device: str | torch.device = "cuda"):
    """Huffman coder fit on the 3-pixel predictor's residuals with chroma
    subsampling. Returns (coder, residual_Y, residual_CbCr), the residuals
    as int32 tensors on ``device``."""
    residual_Y, residual_CbCr = three_pixels_predictor(img_rgb, subsample_color_channels=True,
                                                       device=device)
    all_res = torch.cat([residual_Y.reshape(-1), residual_CbCr[:, :, 0].reshape(-1),
                         residual_CbCr[:, :, 1].reshape(-1)]).cpu().numpy().astype(np.int64)
    min_val = int(all_res.min())
    max_val = int(all_res.max())
    hist = np.bincount(all_res - min_val, minlength=max_val - min_val + 1)
    pmf = hist / hist.sum()
    # the reference trains on the raw pmf (zeros rejected): smooth only the
    # zero bins so every in-range symbol stays encodable
    pmf = np.where(pmf == 0, 1e-12, pmf)
    pmf = pmf / pmf.sum()
    coder = HuffmanCoder(lower_bound=min_val).train(pmf)
    return coder, residual_Y, residual_CbCr


def huffman_encoding(message, encoder: HuffmanCoder):
    """Encode one residual plane or a list of planes.

    One plane -> (words, bitrate, stream_bits, shape); a list -> (streams,
    bitrates, total_stream_bits, shapes). ``stream_bits`` counts 32 bits
    per emitted u32 word, as the reference does.
    """
    if isinstance(message, list):
        streams, bitrates, shapes = [], [], []
        total_bits = 0
        for plane in message:
            words, bitrate, bits, shape = huffman_encoding(plane, encoder)
            streams.append(words)
            bitrates.append(bitrate)
            total_bits += bits
            shapes.append(shape)
        return streams, bitrates, total_bits, shapes
    plane = _host(message)
    words, bitrate = encoder.encode(plane.ravel())
    return words, bitrate, words.size * 32, plane.shape
