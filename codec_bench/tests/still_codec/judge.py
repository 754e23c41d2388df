"""The plain reference's side of ``StillTestCodec``, a still-image codec
that exists only in the benchmark's tests: a judge that owns its numbers
and its control. Imports nothing of the program.

- ``quant_excess``: transform and quantiser. How far beyond half a step
  any symbol of any plane lies from the reference's own coefficient of
  that plane under that plane's table, in quantiser steps.
- ``recon_gap``: the decode. The largest difference, in levels, between
  the RGB image the program decoded and the reference's decoder chain
  (each plane under its own table, then back to RGB) on its symbols.
- ``rate_gap``: the entropy coder. The largest share by which a plane's
  coded bits differ from a Huffman code of that plane's own tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from codec_bench.reference import codec as ref
from codec_bench.reference import judge as numbers_of

NUMBERS = ("quant_excess", "recon_gap", "rate_gap")

# ITU-T T.81 Annex K.1, table K.2 (chrominance)
JPEG_CHROMA = np.array([[17, 18, 24, 47] + [99] * 4, [18, 21, 26, 66] + [99] * 4,
                        [24, 26, 56] + [99] * 5, [47, 66] + [99] * 6] + [[99] * 8] * 4,
                       dtype=np.float64)
# JFIF RGB -> YCbCr (ITU-T T.871 section 7), then + (0, 128, 128)
RGB_TO_YCC = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]])
OFFSET = np.array([0.0, 128.0, 128.0])


def transforms(q: float, device, matmul=ref.f64_matmul) -> list[ref.Transform]:
    """The Y, Cb and Cr planes' transforms: Annex K's luminance table for
    Y, its chrominance table for Cb and Cr, both scaled by ``q``."""
    luma = ref.Transform(q, device, matmul)
    chroma = ref.Transform(q, device, matmul)
    scaled = (JPEG_CHROMA.astype(np.float32) * np.float32(q)).reshape(-1)[ref.zigzag()]
    chroma.qt = torch.tensor(scaled.astype(np.float64), device=device)
    return [luma, chroma, chroma]


def to_ycc(image: torch.Tensor) -> torch.Tensor:
    """``[H, W, 3]`` RGB -> ``[3, H, W]`` float64 YCbCr planes."""
    m = torch.tensor(RGB_TO_YCC, dtype=torch.float64, device=image.device)
    off = torch.tensor(OFFSET, dtype=torch.float64, device=image.device)
    return torch.einsum("cx,hwx->chw", m, image.to(torch.float64)) + off[:, None, None]


def to_rgb(planes: torch.Tensor) -> torch.Tensor:
    """``[3, H, W]`` YCbCr planes -> ``[H, W, 3]`` RGB clipped to [0, 255]."""
    m = torch.linalg.inv(torch.tensor(RGB_TO_YCC, dtype=torch.float64, device=planes.device))
    off = torch.tensor(OFFSET, dtype=torch.float64, device=planes.device)
    return torch.einsum("xc,chw->hwx", m, planes - off[:, None, None]).clamp(0, 255)


def own_bits(qsyms: torch.Tensor, code_of: torch.Tensor | None = None) -> np.ndarray:
    """Each plane's bits under a Huffman code of its own zero-run tokens
    (``code_of``: every plane under the code of these symbols' tokens)."""
    out = []
    for q in qsyms:
        toks, counts = ref.zerorun_tokens(q)
        ctoks, ccounts = (toks, counts) if code_of is None else ref.zerorun_tokens(code_of)
        lo, hi = ref.alphabet(*ref.token_range(ctoks, ccounts))
        lens = ref.frame_code_lengths(ref.token_histogram(ctoks, ccounts, lo, hi))
        out.append(int(ref.coded_bits(toks, counts, lo, lens).sum()))
    return np.asarray(out)


def numbers(src: torch.Tensor, entry: dict, parsed, cfg: dict, device) -> dict:
    """The three numbers of one kept image: ``entry`` holds the program's
    symbols ``qsyms`` ``[3, N, 64]``, its bits a plane ``totals`` and the
    RGB image it decoded ``recons``."""
    dev = torch.device(device)
    trs = transforms(cfg["q"], dev)
    qsyms = torch.as_tensor(entry["qsyms"]).to(dev).to(torch.int64)
    planes = to_ycc(src)
    _, H, W = planes.shape
    excess = max(float(((tr.coefficients(p) / tr.qt - q.to(torch.float64)).abs() - 0.5)
                       .max().clamp_min(0)) for tr, p, q in zip(trs, planes, qsyms))
    chain = to_rgb(torch.stack([tr.reconstruct(q, H, W) for tr, q in zip(trs, qsyms)]))
    decoded = torch.as_tensor(entry["recons"]).to(dev).to(torch.float64)
    return {"quant_excess": excess, "recon_gap": float((decoded - chain).abs().max()),
            "rate_gap": numbers_of.rate_gap(np.asarray(entry["totals"]), own_bits(qsyms))}


def control(kind: str, cell, units: list[torch.Tensor], clip: torch.Tensor, picks: list[int],
            device) -> list[dict]:
    """The reference in the program's place on the picked images:
    ``control`` with TF32 transforms (one precision below the
    configuration's float32), ``stale_code`` at full precision with every
    plane's bits under the Y plane's code."""
    dev = torch.device(device)
    trs = transforms(cell.cfg["q"], dev, ref.tf32_matmul if kind == "control" else ref.f64_matmul)
    kept = []
    for g in picks:
        planes = to_ycc(units[g].to(dev))
        _, H, W = planes.shape
        qsyms = torch.stack([tr.quantise(p) for tr, p in zip(trs, planes)])
        recons = to_rgb(torch.stack([tr.reconstruct(q, H, W) for tr, q in zip(trs, qsyms)]))
        kept.append({"gop": g, "qsyms": qsyms, "recons": recons,
                     "totals": own_bits(qsyms, qsyms[0] if kind == "stale_code" else None)})
    return kept
