"""The default input, for a configuration that names none: a luma clip of
``n_units`` GOPs from ``content.clip``, cut into GOPs of the
configuration's ``T`` frames."""

from __future__ import annotations

import torch

from codec_bench import content


def make(seed: int, cfg: dict, n_units: int, device):
    """(the clip ``[n_units * T, H, W]``, its GOPs ``[T, H, W]`` in order)."""
    T = cfg["T"]
    clip = content.clip(seed, n_units * T, cfg["H"], cfg["W"], torch.device(device))
    return clip, [clip[g * T:(g + 1) * T].contiguous() for g in range(n_units)]
