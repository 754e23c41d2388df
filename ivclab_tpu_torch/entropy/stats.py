"""Probability-mass and entropy statistics.

Port of ``ivclab_tpu/entropy/stats.py`` (the course reference's
stats_marg, smooth_pmf, calc_entropy, min_code_length, basic_histo,
stats_joint and stats_cond). Inputs are numpy arrays or tensors; results
are tensors on the input's device (the CPU for numpy input), except
:func:`smooth_pmf` and :func:`count_rgb_histogram`, which are host numpy.
Histograms use the reference's bin-edge semantics exactly (``np.histogram``
with an edge array: B edges -> B-1 bins, the last bin right-inclusive,
out-of-range values dropped), because its golden entropy values depend on
that quirk.
"""

from __future__ import annotations

import numpy as np
import torch

from ivclab_tpu_torch.utils.shape import as_tensor


def _edge_histogram(values, lo: int, hi: int) -> torch.Tensor:
    """Counts for integer-edge bins ``[lo, lo+1, ..., hi]`` (np.histogram
    rules): bin i counts value lo+i; the last bin also takes value == hi."""
    v = torch.floor(as_tensor(values).reshape(-1).to(torch.float32)).to(torch.int64)
    nbins = hi - lo
    off = torch.where(v == hi, nbins - 1, v - lo)
    valid = (v >= lo) & (v <= hi)
    return torch.bincount(off[valid], minlength=nbins).to(torch.int32)


def stats_marg(image, pixel_range) -> torch.Tensor:
    """Marginal pmf of pixel values over the given bin-edge array,
    normalized by the *total* element count (out-of-range values shrink
    the mass, as in the reference)."""
    edges = np.asarray(pixel_range)
    counts = _edge_histogram(image, int(edges[0]), int(edges[-1]))
    total = int(np.prod(tuple(as_tensor(image).shape)))
    return counts.to(torch.float32) / total


def _sum_f32(p: np.ndarray) -> np.float32:
    """float32 sum in a fixed order: windows of 32 summed left to right
    (the input centred in its zero-padded windows), level by level until at
    most 32 partials remain, then those left to right — the order of the
    JAX package's ``jnp.sum`` on the CPU, so the same pmf comes out."""
    p = np.asarray(p, dtype=np.float32).reshape(-1)
    while p.size > 32:
        m = -(-p.size // 32)
        lo = (m * 32 - p.size) // 2
        q = np.zeros(m * 32, dtype=np.float32)
        q[lo:lo + p.size] = p
        q = q.reshape(m, 32)
        acc = np.zeros(m, dtype=np.float32)
        for j in range(32):
            acc = acc + q[:, j]
        p = acc
    s = np.float32(0.0)
    for v in p:
        s = np.float32(s + v)
    return s


def smooth_pmf(pmf, epsilon: float = 1e-9) -> np.ndarray:
    """Add-epsilon smoothing + renormalize, in float32 on the host.

    The Huffman tree built from a pmf depends on its exact float32 values,
    so the sum runs in one fixed order (:func:`_sum_f32`) whatever device
    the pmf came from. Returns a float32 numpy array.
    """
    if isinstance(pmf, torch.Tensor):
        pmf = pmf.detach().cpu().numpy()
    p = np.asarray(pmf, dtype=np.float32) + np.float32(epsilon)
    return p / _sum_f32(p)


def pmf_from_histogram(hist) -> np.ndarray:
    """``smooth_pmf(hist / sum(hist))`` from an integer histogram, in
    float32 on the host: the codebook-training pmf of the intra codec."""
    if isinstance(hist, torch.Tensor):
        hist = hist.detach().cpu().numpy()
    hist = np.asarray(hist, dtype=np.int64)
    return smooth_pmf(hist.astype(np.float32) / np.float32(hist.sum()))


def calc_entropy(pmf) -> torch.Tensor:
    """Shannon entropy ``-sum p log2 p`` over nonzero bins."""
    p = as_tensor(pmf).to(torch.float32)
    logp = torch.log2(torch.where(p > 0, p, 1.0))
    return -(p * logp).sum()


def min_code_length(target_pmf, common_pmf, eps: float = 1e-8) -> torch.Tensor:
    """Cross-entropy ``-sum p log2 (q + eps)``."""
    p = as_tensor(target_pmf).to(torch.float32)
    q = as_tensor(common_pmf).to(device=p.device, dtype=torch.float32) + eps
    return -(p * torch.log2(q)).sum()


def _pairs_nonoverlapping(image) -> torch.Tensor:
    """Non-overlapping horizontal pixel pairs -> ``[N, 2]``."""
    x = as_tensor(image)
    if x.ndim == 2:
        x = x[:, :, None]
    H, W, C = x.shape
    x = x[:, : (W // 2) * 2, :]
    return x.reshape(H, W // 2, 2, C).permute(0, 1, 3, 2).reshape(-1, 2)


def _pairs_overlapping(image) -> torch.Tensor:
    """Overlapping horizontal pixel pairs -> ``[N, 2]``."""
    x = as_tensor(image)
    if x.ndim == 2:
        x = x[:, :, None]
    return torch.stack([x[:, :-1, :].reshape(-1), x[:, 1:, :].reshape(-1)], dim=-1)


def _joint_counts(pairs: torch.Tensor, lo: int, hi: int):
    """2-D integer-edge histogram (np.histogram2d rules) as a flat bincount."""
    nbins = hi - lo
    v = torch.floor(pairs.to(torch.float32)).to(torch.int64)
    off = torch.where(v == hi, nbins - 1, v - lo)
    valid = ((v >= lo) & (v <= hi)).all(dim=-1)
    flat = off[valid, 0] * nbins + off[valid, 1]
    return torch.bincount(flat, minlength=nbins * nbins).to(torch.int32), nbins


def stats_joint(image, pixel_range, to_flat: bool = True) -> torch.Tensor:
    """Joint pmf of non-overlapping horizontal pairs: one bin per value
    (the full ``arange(last_edge + 2)`` edge array), normalized by the pair
    count."""
    edges = np.asarray(pixel_range)
    counts, nbins = _joint_counts(_pairs_nonoverlapping(image), 0, int(edges[-1]) + 1)
    pmf = counts.to(torch.float32) / counts.sum()
    return pmf if to_flat else pmf.reshape(nbins, nbins)


def stats_cond(image, pixel_range, eps: float = 1e-8, to_flat: bool = False) -> torch.Tensor:
    """Conditional entropy H(right | left) of overlapping horizontal pairs,
    with the raw edge array as histogram2d bins (B edges -> B-1 bins)."""
    del to_flat  # kept for the reference's signature; the result is a scalar
    edges = np.asarray(pixel_range)
    counts, nbins = _joint_counts(_pairs_overlapping(image), int(edges[0]), int(edges[-1]))
    table = counts.to(torch.float32).reshape(nbins, nbins)
    table = table / table.sum()
    p_x = table.sum(dim=1)
    table = table + eps
    p_x = p_x + eps
    return -(table * (torch.log2(table) - torch.log2(p_x)[:, None])).sum()


def basic_histo(image):
    """256-bin intensity histogram(s) for 8-bit images: ``[256]`` for
    grayscale, a tuple of three ``[256]`` for RGB."""
    x = as_tensor(image).clamp(0, 255).to(torch.int64)
    if x.ndim == 2:
        return torch.bincount(x.reshape(-1), minlength=256).to(torch.int32)
    if x.ndim == 3 and x.shape[2] == 3:
        return tuple(torch.bincount(x[:, :, c].reshape(-1), minlength=256).to(torch.int32)
                     for c in range(3))
    raise ValueError("Unsupported image format. Must be 2D grayscale or 3D RGB.")


def count_rgb_histogram(image, grayscale: bool = False):
    """Histogram over the packed 24-bit RGB cube (or 256 gray bins), on the
    host: a dict ``{packed_value: count}`` for colour images."""
    img = image.detach().cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)
    if grayscale and img.ndim == 3:
        img = np.mean(img, axis=-1)
    if img.ndim == 2:
        return np.bincount(np.clip(img, 0, 255).astype(np.int64).ravel(), minlength=256)
    flat = img.reshape(-1, img.shape[2]).astype(np.int64)
    packed = flat[:, 0] * 256**2 + flat[:, 1] * 256 + flat[:, 2]
    values, counts = np.unique(packed, return_counts=True)
    return dict(zip(values.tolist(), counts.tolist()))


def histogram_int32(values: torch.Tensor, lo: int, hi: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Histogram of int symbols over ``[lo, hi)`` as ``[hi - lo]`` int32.

    ``mask`` marks the valid entries (padded symbol buffers); out-of-range
    symbols are dropped.
    """
    v = values.reshape(-1).to(torch.int64)
    valid = (v >= lo) & (v < hi)
    if mask is not None:
        valid = valid & mask.reshape(-1).to(torch.bool)
    return torch.bincount(v[valid] - lo, minlength=hi - lo).to(torch.int32)
