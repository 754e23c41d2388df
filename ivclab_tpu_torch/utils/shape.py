"""Block (un)patching, JPEG zig-zag order and padding as layout transforms.

Port of ``ivclab_tpu/utils/shape.py``. The zig-zag permutation is derived
from the anti-diagonal traversal rule; the codec folds it into the DCT
matrix rows (``ops/dct.py``) and the quantization tables
(``ops/quant.py``), and :class:`ZigZag` applies it as a gather.
:class:`Patcher` is a reshape and a permute. Inputs are tensors (kept on
their device) or numpy arrays (taken to the CPU).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is, or a numpy array (or list) as a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, copy=True))


def upload(a, device) -> torch.Tensor:
    """A copy of the numpy array ``a`` as a tensor on ``device``.

    On a CUDA device the array is staged in pinned host memory and copied
    without blocking: a copy from pageable memory makes the host wait for
    everything queued on the card first. PyTorch's caching host allocator
    keeps the staging buffer until the copy has run.
    """
    a = np.asarray(a)
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.from_numpy(np.array(a, order="C")).to(dev)
    host = torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                       pin_memory=True)
    host.numpy()[...] = a
    return host.to(dev, non_blocking=True)


@functools.lru_cache(maxsize=None)
def zigzag_scan_positions(n: int = 8) -> tuple[tuple[int, int], ...]:
    """(row, col) positions of an n x n block in JPEG zig-zag scan order.

    Walk anti-diagonals d = r + c from 0 to 2n-2; even diagonals run
    bottom-left -> top-right, odd ones top-right -> bottom-left.
    """
    positions = []
    for d in range(2 * n - 1):
        rng = range(max(0, d - n + 1), min(d, n - 1) + 1)
        rows = list(rng)[::-1] if d % 2 == 0 else list(rng)
        for r in rows:
            positions.append((r, d - r))
    return tuple(positions)


@functools.lru_cache(maxsize=None)
def zigzag_gather_indices(n: int = 8) -> np.ndarray:
    """Flat row-major indices such that ``flat[idx]`` is in scan order."""
    idx = np.asarray([r * n + c for r, c in zigzag_scan_positions(n)], dtype=np.int32)
    idx.setflags(write=False)
    return idx


@functools.lru_cache(maxsize=None)
def zigzag_scatter_indices(n: int = 8) -> np.ndarray:
    """Inverse permutation: the scan index of each row-major position (the
    course reference's ``ZigZag.zigzag_order`` table, derived)."""
    gather = zigzag_gather_indices(n)
    inv = np.empty_like(gather)
    inv[gather] = np.arange(n * n, dtype=np.int32)
    inv.setflags(write=False)
    return inv


class ZigZag:
    """Flattens ``[..., n, n]`` blocks into zig-zag-ordered ``[..., n*n]``
    and back, for any leading batch shape."""

    def __init__(self, n: int = 8):
        self.n = n
        self._gather = torch.from_numpy(zigzag_gather_indices(n).astype(np.int64))

    def flatten(self, patched_img) -> torch.Tensor:
        x = as_tensor(patched_img)
        flat = x.reshape(*x.shape[:-2], self.n * self.n)
        return flat[..., self._gather.to(x.device)]

    def unflatten(self, zigzagged) -> torch.Tensor:
        z = as_tensor(zigzagged)
        flat = torch.empty_like(z)
        flat[..., self._gather.to(z.device)] = z
        return flat.reshape(*z.shape[:-1], self.n, self.n)


class Patcher:
    """Image ``[H, W, C]`` (or ``[H, W]``) <-> blocks ``[H/ph, W/pw, C, ph, pw]``."""

    def __init__(self, window_size=(8, 8)):
        self.window_size = tuple(window_size)

    def patch(self, img) -> torch.Tensor:
        x = as_tensor(img)
        if x.ndim == 2:
            x = x[:, :, None]
        H, W, C = x.shape
        ph, pw = self.window_size
        if H % ph or W % pw:
            raise ValueError(f"image {H}x{W} not a multiple of window {self.window_size}")
        return x.reshape(H // ph, ph, W // pw, pw, C).permute(0, 2, 4, 1, 3)

    def unpatch(self, patched_img) -> torch.Tensor:
        x = as_tensor(patched_img)
        hp, wp, C, ph, pw = x.shape
        return x.permute(0, 3, 1, 4, 2).reshape(hp * ph, wp * pw, C)


@functools.lru_cache(maxsize=None)
def _pad_index(n: int, lo: int, hi: int, mode: str) -> torch.Tensor:
    """Source index of each position of a length-n axis padded by (lo, hi)
    in numpy's ``mode`` ('edge', 'symmetric', 'reflect', 'wrap')."""
    return torch.from_numpy(np.pad(np.arange(n, dtype=np.int64), (lo, hi), mode=mode))


def pad2d(x: torch.Tensor, pad, mode: str = "symmetric") -> torch.Tensor:
    """``np.pad`` of the first two axes of ``x`` (``pad`` is
    ``((top, bottom), (left, right))``): zeros for mode 'constant', else a
    gather of each axis through numpy's index rule for ``mode``."""
    (t, b), (l, r) = pad
    if mode == "constant":
        moved = x.movedim((0, 1), (-2, -1))
        return torch.nn.functional.pad(moved, (l, r, t, b)).movedim((-2, -1), (0, 1))
    if t or b:
        x = x.index_select(0, _pad_index(x.shape[0], t, b, mode).to(x.device))
    if l or r:
        x = x.index_select(1, _pad_index(x.shape[1], l, r, mode).to(x.device))
    return x


def pad_to_block_multiple(img, block=(8, 8), mode: str = "edge"):
    """Pad ``[H, W, ...]`` so H and W are multiples of the block size (the
    course reference's edge padding). Returns (padded, (H, W))."""
    x = as_tensor(img)
    H, W = x.shape[0], x.shape[1]
    ph = (-H) % block[0]
    pw = (-W) % block[1]
    if ph or pw:
        x = pad2d(x, ((0, ph), (0, pw)), mode)
    return x, (H, W)
