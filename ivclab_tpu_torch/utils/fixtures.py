"""Deterministic synthetic test/benchmark imagery (numpy).

A copy of ``ivclab_tpu/utils/fixtures.py`` (``image``, ``degraded``,
``video`` and ``video_1080p``): the same name, length and shape give the
same pixels; ``walk_streams`` and ``canon_walk_streams`` (corrupt
entropy streams for the two decode walks) are the port's own. The
course reference validates against real images and sequences distributed
out of band; these are reproducible stand-ins with natural-image-like
statistics (multi-octave smooth value noise + edges + texture) and real
motion.

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


_NAMED = {
    # name: (seed, (H, W))  — stand-ins for the reference data/ images
    "lena": (1001, (512, 512)),
    "lena_small": (1001, (256, 256)),
    "sail": (1002, (480, 640)),
    "smandril": (1003, (512, 512)),
    "peppers": (1004, (512, 512)),
    "monarch": (1005, (512, 768)),
    "satpic1": (1006, (384, 512)),
}


@functools.lru_cache(maxsize=None)
def image(name: str) -> np.ndarray:
    """Named deterministic RGB uint8 fixture image."""
    if name not in _NAMED:
        raise KeyError(f"unknown fixture {name!r}; have {sorted(_NAMED)}")
    seed, shape = _NAMED[name]
    return _synth_rgb(seed, shape)


@functools.lru_cache(maxsize=None)
def degraded(name: str, seed: int = 7, noise: float = 35.0) -> np.ndarray:
    """A heavily degraded reconstruction pair for MSE/PSNR tests (stand-in
    for the reference's precompressed lena_rec.tif)."""
    rng = np.random.default_rng(seed)
    img = image(name).astype(np.float64)
    blur = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0) + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    noisy = blur + noise * rng.standard_normal(img.shape)
    return np.clip(np.round(noisy), 0, 255).astype(np.uint8)


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


def video_1080p(num_frames: int = 8) -> np.ndarray:
    """1080p benchmark sequence (1088 x 1920, the throughput workload)."""
    return video("bench1080", num_frames=num_frames, shape=(1088, 1920))


def walk_streams(seed: int, B: int = 512, LW: int = 4, max_syms: int = 40, min_len: int = 1,
                 raw_bits: int = 24, max_len: int = 16, n_ranks: int = 5,
                 esc_rank: int | None = None, lj=None) -> dict:
    """Random hot/escape streams and decoder tables that take the decode
    walk (``ops/bitpack.py::decode_blocks_hot``) through its edge cases.

    Random words are corrupt codes. ``min_len`` sets where code lengths
    fall: below 0 (``min_len < 0``), past ``max_len`` (out of the table) or
    past 32 (``min_len > 16``). Random first codes and group offsets wrap
    ranks past int32 and clamp them; the first four lengths get small ones,
    so middle ranks occur too. The escape is the last of ``n_ranks`` ranks
    unless ``esc_rank`` says otherwise (rank 0 is where lengths outside the
    table land), so escapes are common; length 8 sends every code to the
    last rank, so with ``raw_bits`` 24 its escapes advance exactly 32
    bits. Streams of ``LW`` words are read past their end, and counts run
    from -2 to past ``max_syms``. ``lj`` replaces the bounds (int64, as
    :func:`prefix_bounds` makes them; every other array is the same).

    Returns the walk's arguments as numpy arrays in the JAX tables' types
    (uint32 words, bounds and first codes; int32 counts, group offsets and
    ranks) and ints.
    """
    rng = np.random.default_rng(seed)
    first_code = rng.integers(0, 2**32, 33, dtype=np.uint64).astype(np.uint32)
    group_offset = rng.integers(-(2**31), 2**31, 33, dtype=np.int64).astype(np.int32)
    first_code[:4] = 0
    group_offset[:4] = rng.integers(-2, n_ranks, 4)
    first_code[8], group_offset[8] = 0, n_ranks - 1
    c = {
        "local": rng.integers(0, 2**32, (B, LW), dtype=np.uint64).astype(np.uint32),
        "counts": rng.integers(-2, max_syms + 8, B).astype(np.int32),
        "lj": np.sort(rng.integers(0, 2**32, 32, dtype=np.uint64)).astype(np.uint32),
        "first_code": first_code,
        "group_offset": group_offset,
        "alpha_of_rank": rng.integers(0, 1 << min(raw_bits, 30), n_ranks).astype(np.int32),
        "min_len": int(min_len),
        "esc_rank": n_ranks - 1 if esc_rank is None else int(esc_rank),
        "max_syms": int(max_syms),
        "raw_bits": int(raw_bits),
        "max_len": int(max_len),
    }
    if lj is not None:
        c["lj"] = np.asarray(lj, dtype=np.int64)
    return c


# The kinds of :func:`prefix_bounds`.
PREFIX_BOUND_KINDS = ("unsorted", "duplicate", "wild", "inside", "clustered", "edges")


def prefix_bounds(kind: str, seed: int, n: int = 31, bits: int = 10) -> np.ndarray:
    """``n`` adversarial code bounds (int64) for the decode walks' prefix
    table (``ops/bitpack.py::prefix_table``) of ``2^bits`` prefixes, each
    prefix p the windows [lo, hi) = [p, p + 1) << (32 - bits):

    - ``"unsorted"``: random values below 2^32 - 1 in no order;
    - ``"duplicate"``: four values, each repeated;
    - ``"wild"``: negative values, 2^32 - 1 and values past 2^32 (which the
      hot walk's int64 compares count always or never; the canonical walk
      takes their low 32 bits), mixed with random ones;
    - ``"inside"``: each bound strictly inside a random prefix's range
      ([lo, hi - 2]), so every bound makes its prefix compare;
    - ``"clustered"``: bounds inside the first prefix, where the zero
      windows past a ``walk_streams`` block land, and inside the last,
      where the all-ones words of ``canon_walk_streams`` land;
    - ``"edges"``: lo - 1, lo, hi - 2 and hi - 1 of random prefixes, the
      values at which the rule changes.
    """
    rng = np.random.default_rng(seed)
    s = 32 - bits
    span = 1 << s
    lo = rng.integers(0, 1 << bits, n).astype(np.int64) << s
    if kind == "unsorted":
        v = rng.integers(0, 2**32 - 1, n, dtype=np.int64)
    elif kind == "duplicate":
        v = rng.choice(rng.integers(0, 2**32 - 1, 4, dtype=np.int64), n)
    elif kind == "wild":
        v = np.select([np.arange(n) % 4 == k for k in range(3)],
                      [rng.integers(-(2**40), 0, n), np.full(n, 2**32 - 1, dtype=np.int64),
                       rng.integers(2**32, 2**40, n)],
                      rng.integers(0, 2**32 - 1, n, dtype=np.int64))
    elif kind == "inside":
        v = lo + rng.integers(0, span - 1, n)
    elif kind == "clustered":
        last = ((1 << bits) - 1) << s
        v = np.where(np.arange(n) % 2 == 0, 0, last) + rng.integers(0, span - 1, n)
    elif kind == "edges":
        v = lo + np.array([-1, 0, span - 2, span - 1])[np.arange(n) % 4]
    else:
        raise ValueError(f"kind {kind!r} is none of {PREFIX_BOUND_KINDS}")
    return rng.permutation(v).astype(np.int64)


def canon_walk_streams(seed: int, B: int = 512, n_words: int = 64, max_syms: int = 40,
                       min_len: int = 1, n_sym: int = 300, code: str = "random",
                       max_len: int = 32, lj=None) -> dict:
    """A random word stream, block offsets and counts, and decoder tables
    that take the canonical walk (``ops/bitpack.py::decode_blocks_device``)
    through its edge cases.

    Random words are corrupt codes; one word in eight is all ones, which
    makes the longest codes. The block offsets fall in six bands: inside
    the stream, past its end, in its last 64 words counted back from bit 0
    (a negative word index counts from the stream's end), further below 0
    (the index clamps to word 0), within 16 words below 2^31 (the int32 bit
    position wraps during the walk) and at -2^31. Counts run from -2 to
    past ``max_syms``.

    ``code`` picks the tables: ``"random"``, random sorted bounds, first
    codes and group offsets (the first four lengths get small offsets, so
    middle ranks occur) over ``n_sym`` random symbols, with ``max_len``
    (default 32, so lengths reach ``min_len + 31``, past 32 when
    ``min_len > 1``; below 32 the last compared bound weighs 32 -
    ``max_len``) and ranks that wrap past int32 and clamp; ``"skewed"``, the canonical code of a
    40-symbol pmf ``2^-k``, whose longest codes are 32 bits;
    ``"laplacian"``, the canonical code of an ``n_sym``-symbol Laplacian pmf
    limited to 16 bits, where the walk compares only ``max_len`` bounds.

    ``lj`` replaces the bounds (int64, as :func:`prefix_bounds` makes them;
    every other array is the same).

    Returns the walk's arguments as numpy arrays in the JAX tables' types
    (uint32 words, bounds and first codes; int32 offsets, counts, group
    offsets and symbols) and ints (``min_len``, ``max_len``, ``max_syms``).
    """
    from ivclab_tpu_torch.entropy.codebook import build_canonical_code

    rng = np.random.default_rng(seed)
    bits = n_words * 32
    band = rng.integers(0, 6, B)
    offs = np.select(
        [band == 0, band == 1, band == 2, band == 3, band == 4],
        [rng.integers(0, bits, B), rng.integers(bits, bits + 4096, B),
         rng.integers(-min(bits, 64 * 32), 0, B), rng.integers(-(2**31), -bits, B),
         rng.integers(2**31 - 16 * 32, 2**31, B)],
        -(2**31))
    if code == "random":
        first_code = rng.integers(0, 2**32, 33, dtype=np.uint64).astype(np.uint32)
        group_offset = rng.integers(-(2**31), 2**31, 33, dtype=np.int64).astype(np.int32)
        first_code[:4] = 0
        group_offset[:4] = rng.integers(-2, n_sym, 4)
        tables = {
            "lj": np.sort(rng.integers(0, 2**32, 32, dtype=np.uint64)).astype(np.uint32),
            "first_code": first_code,
            "group_offset": group_offset,
            "sorted_syms": rng.integers(-(2**31), 2**31, n_sym, dtype=np.int64).astype(np.int32),
            "min_len": int(min_len),
            "max_len": int(max_len),
        }
    elif code in ("skewed", "laplacian"):
        if code == "skewed":
            pmf, limit = 2.0 ** -np.arange(40), 32
        else:
            pmf, limit = np.exp(-np.abs(np.arange(n_sym) - n_sym // 2) / 6.0) + 1e-9, 16
        c = build_canonical_code(pmf / pmf.sum(), lower_bound=0, max_len=limit)
        tables = {
            "lj": np.asarray(c.lj_next_minus1, dtype=np.uint32),
            "first_code": np.asarray(c.first_code, dtype=np.uint32),
            "group_offset": np.asarray(c.group_offset, dtype=np.int32),
            "sorted_syms": np.asarray(c.sorted_syms, dtype=np.int32),
            "min_len": int(c.min_len),
            "max_len": max(int(c.max_len), 1),
        }
    else:
        raise ValueError(f"code {code!r} is none of 'random', 'skewed', 'laplacian'")
    words = rng.integers(0, 2**32, n_words, dtype=np.uint64).astype(np.uint32)
    words[rng.random(n_words) < 1 / 8] = 0xFFFFFFFF
    c = {
        "words": words,
        "offsets": offs.astype(np.int64).astype(np.int32),
        "counts": rng.integers(-2, max_syms + 8, B).astype(np.int32),
        **tables,
        "max_syms": int(max_syms),
    }
    if lj is not None:
        c["lj"] = np.asarray(lj, dtype=np.int64)
    return c
