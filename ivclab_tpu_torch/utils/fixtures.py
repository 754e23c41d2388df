"""Deterministic synthetic test/benchmark imagery (numpy).

A copy of the video part of ``ivclab_tpu/utils/fixtures.py``: the same
name, length and shape give the same pixels. The course reference
validates against real sequences distributed out of band; these are
reproducible stand-ins with natural-image-like statistics (multi-octave
smooth value noise + edges + texture) and real motion.

Everything is a pure function of the fixture name — no files, no RNG state.
"""

from __future__ import annotations

import functools

import numpy as np


def _value_noise(rng: np.random.Generator, shape, octaves=((8, 1.0), (32, 0.5), (128, 0.25))):
    """Sum of bilinearly-upsampled random grids -> smooth 'natural' field in [0,1]."""
    H, W = shape
    out = np.zeros((H, W), dtype=np.float64)
    for grid, amp in octaves:
        gh, gw = max(2, min(grid, H)), max(2, min(grid, W))
        coarse = rng.random((gh, gw))
        ys = np.linspace(0, gh - 1, H)
        xs = np.linspace(0, gw - 1, W)
        y0 = np.clip(ys.astype(int), 0, gh - 2)
        x0 = np.clip(xs.astype(int), 0, gw - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        c00 = coarse[y0][:, x0]
        c01 = coarse[y0][:, x0 + 1]
        c10 = coarse[y0 + 1][:, x0]
        c11 = coarse[y0 + 1][:, x0 + 1]
        out += amp * ((1 - fy) * ((1 - fx) * c00 + fx * c01) + fy * ((1 - fx) * c10 + fx * c11))
    out -= out.min()
    peak = out.max()
    if peak > 0:
        out /= peak
    return out


def _paint_shapes(rng: np.random.Generator, base: np.ndarray, n: int = 12) -> np.ndarray:
    """Overlay flat-ish rectangles and ellipses to create hard edges."""
    H, W = base.shape
    img = base.copy()
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(n):
        cy, cx = rng.integers(0, H), rng.integers(0, W)
        ry, rx = rng.integers(H // 16, H // 4), rng.integers(W // 16, W // 4)
        level = rng.random()
        if rng.random() < 0.5:
            mask = (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
        else:
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        img[mask] = 0.35 * img[mask] + 0.65 * level
    return img


def _synth_rgb(seed: int, shape, texture: float = 0.04, shapes: int = 12) -> np.ndarray:
    H, W = shape
    rng = np.random.default_rng(seed)
    luma = _paint_shapes(rng, _value_noise(rng, (H, W)), n=shapes)
    chroma_u = _value_noise(rng, (H, W), octaves=((4, 1.0), (16, 0.3)))
    chroma_v = _value_noise(rng, (H, W), octaves=((4, 1.0), (16, 0.3)))
    luma = luma + texture * rng.standard_normal((H, W))
    y = 16 + 219 * np.clip(luma, 0, 1)
    cb = 96 + 64 * chroma_u
    cr = 96 + 64 * chroma_v
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def video(name: str = "foreman", num_frames: int = 21, shape=(288, 352)) -> np.ndarray:
    """Deterministic CIF-like sequence ``[T, H, W, 3]`` with real motion.

    Global pan (sub-±3 px/frame) of a larger background plus two
    independently translating foreground objects, so block motion search
    with search_range=4 (the ch4 workload, ``exercises/ch4/E4-1.py:360``)
    has genuine structure to find.
    """
    H, W = shape
    # zlib.crc32 is stable across processes; Python's hash() is salted per
    # process (PYTHONHASHSEED), which made every bench run generate a
    # different sequence and drift mean_bpp run to run
    import zlib

    seed = 2000 + (zlib.crc32(name.encode()) % 1000 if name != "foreman" else 0)
    rng = np.random.default_rng(seed)
    margin = 64
    bg = _synth_rgb(seed, (H + 2 * margin, W + 2 * margin), shapes=20).astype(np.float64)

    obj_a = _synth_rgb(seed + 1, (48, 48), shapes=3).astype(np.float64)
    obj_b = _synth_rgb(seed + 2, (32, 64), shapes=3).astype(np.float64)

    frames = np.empty((num_frames, H, W, 3), dtype=np.uint8)
    for t in range(num_frames):
        # Smooth global pan within +/- 3 px/frame; clamped so long
        # sequences never run off the oversized background
        oy = min(max(margin + int(round(10 * np.sin(t / 6.0))), 0), 2 * margin)
        ox = min(max(margin + int(round(2.2 * t)), 0), 2 * margin)
        frame = bg[oy : oy + H, ox : ox + W].copy()

        ay = min(max(int(round(H * 0.3 + 3.0 * t)), 0), H - 48)
        ax = min(max(int(round(W * 0.2 + 1.5 * t)), 0), W - 48)
        frame[ay : ay + 48, ax : ax + 48] = obj_a

        by = min(max(int(round(H * 0.6 - 1.0 * t)), 0), H - 32)
        bx = min(max(int(round(W * 0.7 - 2.5 * t)), 0), W - 64)
        frame[by : by + 32, bx : bx + 64] = obj_b

        frame += 1.5 * rng.standard_normal(frame.shape)
        frames[t] = np.clip(np.round(frame), 0, 255).astype(np.uint8)
    return frames

