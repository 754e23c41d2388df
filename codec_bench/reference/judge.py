"""The numbers that decide ``correct``, worked out by the plain reference.

Each takes what the program produced for one GOP and the source frames the
benchmark made, and returns how far the program departs from the codec's
definition:

- ``me_gap``: motion search. For every block of every P-frame, the SSD of
  the program's vector less the least SSD of any candidate, over the 64
  pixels (squared levels a pixel), both against the reference's own
  reconstruction of the previous frame. A vector off the frame reads inf.
- ``quant_excess``: transform and quantiser. How far beyond half a step
  any symbol lies from the reference's own coefficient of the same
  residual (source less the reference's prediction), in quantiser steps.
- ``recon_gap``: the decode. The largest difference, in levels, between
  the frames the program decoded and the reference's decoder chain run on
  the program's symbols and motion.
- ``rate_gap``: the entropy coder. The largest share by which a frame's
  coded bits differ from what the reference's own codebook gives the same
  symbols.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from codec_bench.reference import codec as ref


def gop_numbers(src: torch.Tensor, qsyms: torch.Tensor, mvs: torch.Tensor,
                decoded: torch.Tensor, tr: ref.Transform, sr: int) -> dict:
    """``me_gap``, ``quant_excess`` and ``recon_gap`` of one GOP.

    ``src`` ``[T, H, W]`` source frames; ``qsyms`` ``[T, N, 64]`` the
    program's scan-ordered symbols; ``mvs`` ``[T, H/8, W/8]`` its packed
    motion (frame 0's is not read); ``decoded`` ``[T, H, W]`` its decoded
    frames. All on one device.
    """
    T, H, W = src.shape
    n_cand = (2 * sr + 1) ** 2
    chain = ref.reconstruct_gop(qsyms, mvs, tr, sr, H, W)
    me_gap, excess = 0.0, 0.0
    for t in range(T):
        y = src[t].to(torch.float64)
        if t == 0:
            pred = torch.zeros_like(y)
        else:
            mv = mvs[t].to(torch.int64)
            if bool(((mv < 0) | (mv >= n_cand)).any()):
                return {"me_gap": math.inf, "quant_excess": math.inf, "recon_gap": math.inf}
            ssd = ref.candidate_ssd(chain[t - 1], y, sr)
            chosen = ssd.gather(0, mv[None])[0]
            me_gap = max(me_gap, float(((chosen - ssd.min(0).values) / 64).max()))
            pred = ref.compensate(chain[t - 1], mv, sr)
        scaled = tr.coefficients(y - pred) / tr.qt
        dev = (scaled - qsyms[t].to(torch.float64)).abs() - 0.5
        excess = max(excess, float(dev.max().clamp_min(0)))
    gap = float((decoded.to(torch.float64) - chain).abs().max())
    return {"me_gap": me_gap, "quant_excess": excess, "recon_gap": gap}


def rate_gap(program_bits, reference_bits) -> float:
    """Largest share by which a frame's bits differ from the reference's."""
    p = np.asarray(program_bits, dtype=np.float64)
    r = np.asarray(reference_bits, dtype=np.float64)
    return float(np.max(np.abs(p - r) / np.maximum(r, 1.0)))


def worst(readings: list[dict]) -> dict:
    """The largest reading of every number over several GOPs."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), float(v))
    return out
