"""Symbol-bound helpers shared with the intra codec.

Port of ``bucket_bounds`` and ``_sym_min_max`` from
``ivclab_tpu/models/intracodec.py``: codebook training bounds are widened
by a safety margin and bucketed to multiples of 64, so the trained
alphabet is a contiguous range that covers the training symbols.
"""

from __future__ import annotations

import torch

_BOUND_BUCKET = 64
_SAFETY_MARGIN = 20  # matches the course reference's +/-20 margin


def _sym_min_max(buf: torch.Tensor, valid_len: torch.Tensor):
    """(min, max) over the valid symbols of per-block buffers."""
    pos = torch.arange(buf.shape[1], device=buf.device)
    mask = pos[None, :] < valid_len[:, None]
    mn = torch.where(mask, buf, 2**31 - 1).min()
    mx = torch.where(mask, buf, -(2**31 - 1)).max()
    return mn, mx


def bucket_bounds(mn: int, mx: int, margin: int = _SAFETY_MARGIN, bucket: int = _BOUND_BUCKET):
    lo = ((mn - margin) // bucket) * bucket
    hi = -((-(mx + margin + 1)) // bucket) * bucket
    return int(lo), int(hi)
