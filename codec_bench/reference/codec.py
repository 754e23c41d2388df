"""Plain reference of the hybrid video codec's mathematics.

Written from the published description of the lab's codec (the course
reference's ``VideoCodec`` / ``AdaptiveVideoCodec``, ``exercises/ch4``) and
of JPEG (ITU-T T.81: the zig-zag scan, the Annex K luminance table), in plain
PyTorch. It imports nothing of the program and takes nothing the program
made: the DCT matrix, the scan, the tables, the motion search, the zero-run
tokens and the Huffman codes are all worked out here again.

Arithmetic is float64 on whatever device the tensors live on. ``matmul``
arguments select the precision of the two transforms, which is where a
lower-precision control differs (:func:`tf32_matmul`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

EOB = 4000
BLOCK = 8

# ITU-T T.81 Annex K.1, table K.1 (luminance).
JPEG_LUMA = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 55, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float64,
)


# ------------------------------------------------------------------ transform


def zigzag() -> np.ndarray:
    """JPEG scan order: row-major positions of an 8x8 block, anti-diagonal by
    anti-diagonal, odd diagonals walked down-left, even ones up-right."""
    order = []
    for s in range(2 * BLOCK - 1):
        cells = [(i, s - i) for i in range(BLOCK) if 0 <= s - i < BLOCK]
        if s % 2 == 0:
            cells.reverse()
        order.extend(i * BLOCK + j for i, j in cells)
    return np.asarray(order)


def forward_matrix() -> np.ndarray:
    """``[64, 64]`` float64: scan-ordered 2-D DCT-II of a row-major block."""
    k = np.arange(BLOCK)[:, None]
    m = np.arange(BLOCK)[None, :]
    D = np.sqrt(2.0 / BLOCK) * np.cos(np.pi * (2 * m + 1) * k / (2 * BLOCK))
    D[0] /= np.sqrt(2.0)
    return np.kron(D, D)[zigzag()]


def quant_table(q: float) -> np.ndarray:
    """Scan-ordered luminance table scaled by ``q``, as float32 values."""
    return (JPEG_LUMA.astype(np.float32) * np.float32(q)).reshape(-1)[zigzag()].astype(np.float64)


def f64_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float64), b.to(torch.float64))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 stored mantissa bits), to nearest."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 product whose operands are rounded to TF32 first, as the
    tensor cores' TF32 mode computes it: the control's precision."""
    return torch.matmul(_tf32(a), _tf32(b)).to(torch.float64)


class Transform:
    """The codec's 8x8 transform and quantiser on one device."""

    def __init__(self, q: float, device, matmul=f64_matmul):
        F = forward_matrix()
        self.fwd_t = torch.tensor(F.T, dtype=torch.float64, device=device)
        self.inv_t = torch.tensor(F, dtype=torch.float64, device=device)
        self.qt = torch.tensor(quant_table(q), dtype=torch.float64, device=device)
        self.matmul = matmul

    def coefficients(self, plane: torch.Tensor) -> torch.Tensor:
        """``[H, W]`` -> scan-ordered coefficients ``[N, 64]`` float64."""
        return self.matmul(to_blocks(plane), self.fwd_t)

    def quantise(self, plane: torch.Tensor) -> torch.Tensor:
        """``[H, W]`` -> quantised symbols ``[N, 64]`` int64 (round half even)."""
        return torch.round(self.coefficients(plane) / self.qt).to(torch.int64)

    def reconstruct(self, qsyms: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """Symbols ``[N, 64]`` -> pixels ``[H, W]``: dequantise by truncation
        toward zero, then the inverse transform."""
        deq = torch.trunc(qsyms.to(torch.float64) * self.qt)
        return from_blocks(self.matmul(deq, self.inv_t), H, W)


def to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """``[H, W]`` -> row-major 8x8 blocks ``[N, 64]``, blocks in raster order."""
    H, W = plane.shape
    return plane.reshape(H // 8, 8, W // 8, 8).permute(0, 2, 1, 3).reshape(-1, 64)


def from_blocks(blocks: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return blocks.reshape(H // 8, W // 8, 8, 8).permute(0, 2, 1, 3).reshape(H, W)


# ------------------------------------------------------------------ motion


def candidate_ssd(ref: torch.Tensor, cur: torch.Tensor, sr: int,
                  dtype=torch.float64) -> torch.Tensor:
    """``[(2 sr + 1)**2, H/8, W/8]`` sums of squared differences of every
    block of ``cur`` against every displaced block of ``ref``, in the packed
    order ``(dy + sr) * (2 sr + 1) + (dx + sr)``, computed in ``dtype`` and
    returned as float64; candidates that leave the frame are +inf."""
    H, W = cur.shape
    hb, wb = H // 8, W // 8
    ref = ref.to(dtype)
    cur = cur.to(dtype)
    pad = torch.nn.functional.pad(ref[None, None], (sr, sr, sr, sr))[0, 0]
    by = torch.arange(hb, device=cur.device) * 8
    bx = torch.arange(wb, device=cur.device) * 8
    out = []
    for dy in range(-sr, sr + 1):
        ok_y = (by + dy >= 0) & (by + dy + 8 <= H)
        for dx in range(-sr, sr + 1):
            ok_x = (bx + dx >= 0) & (bx + dx + 8 <= W)
            cand = pad[sr + dy:sr + dy + H, sr + dx:sr + dx + W]
            ssd = ((cur - cand) ** 2).reshape(hb, 8, wb, 8).sum(dim=(1, 3)).to(torch.float64)
            out.append(ssd.masked_fill(~(ok_y[:, None] & ok_x[None, :]), math.inf))
    return torch.stack(out)


def motion_search(ref: torch.Tensor, cur: torch.Tensor, sr: int,
                  dtype=torch.float64) -> torch.Tensor:
    """Full search: the first candidate in scan order with the least SSD."""
    return torch.argmin(candidate_ssd(ref, cur, sr, dtype), dim=0)


def compensate(ref: torch.Tensor, mv: torch.Tensor, sr: int) -> torch.Tensor:
    """Move every 8x8 tile of ``ref`` by its packed motion index; source
    coordinates clip to the frame."""
    H, W = ref.shape
    n = 2 * sr + 1
    mv = mv.to(device=ref.device, dtype=torch.int64)
    dy = torch.div(mv, n, rounding_mode="floor") - sr
    dx = mv % n - sr
    rows = torch.arange(H, device=ref.device)[:, None] + dy.repeat_interleave(8, 0).repeat_interleave(8, 1)
    cols = torch.arange(W, device=ref.device)[None, :] + dx.repeat_interleave(8, 0).repeat_interleave(8, 1)
    return ref[rows.clamp(0, H - 1), cols.clamp(0, W - 1)]


def encode_gop(frames: torch.Tensor, tr: Transform, sr: int, ssd_dtype=torch.float64):
    """Closed-loop I/P coding of ``[T, H, W]`` frames: frame 0 intra, every
    later frame predicted from the previous reconstruction, the search's
    SSDs in ``ssd_dtype``. Returns
    (symbols ``[T, N, 64]`` int64, motion ``[T, H/8, W/8]`` int64 with the
    zero vector on frame 0, reconstructions ``[T, H, W]`` float64)."""
    T, H, W = frames.shape
    zero = sr * (2 * sr + 1) + sr
    qs, mvs, recons, recon = [], [], [], None
    for t in range(T):
        y = frames[t].to(torch.float64)
        if t == 0:
            mv = torch.full((H // 8, W // 8), zero, dtype=torch.int64, device=y.device)
            pred = torch.zeros_like(y)
        else:
            mv = motion_search(recon, y, sr, ssd_dtype)
            pred = compensate(recon, mv, sr)
        q = tr.quantise(y - pred)
        recon = pred + tr.reconstruct(q, H, W)
        qs.append(q)
        mvs.append(mv)
        recons.append(recon)
    return torch.stack(qs), torch.stack(mvs), torch.stack(recons)


def reconstruct_gop(qsyms: torch.Tensor, mvs: torch.Tensor, tr: Transform, sr: int, H: int,
                    W: int) -> torch.Tensor:
    """The decoder's chain from symbols and motion: ``[T, H, W]`` float64."""
    recons, recon = [], None
    for t in range(qsyms.shape[0]):
        rrec = tr.reconstruct(qsyms[t], H, W)
        recon = rrec if t == 0 else compensate(recon, mvs[t], sr) + rrec
        recons.append(recon)
    return torch.stack(recons)


# ------------------------------------------------------------------ zero-run


def zerorun_tokens(qsyms: torch.Tensor, eob: int = EOB):
    """Zero-run tokens of scan-ordered blocks ``[N, 64]``: each nonzero value
    up to the block's last one as itself, each run of zeros before it as
    ``0, run``, then ``eob``. Returns (tokens ``[N, 128]`` int64, zero past
    each count; counts ``[N]`` int64)."""
    x = qsyms.to(torch.int64)
    N = x.shape[0]
    pos = torch.arange(64, device=x.device)
    nz = x != 0
    last = torch.where(nz, pos, -1).amax(dim=1)
    inside = pos[None, :] <= last[:, None]
    prev_nz = torch.cat([torch.ones((N, 1), dtype=torch.bool, device=x.device), nz[:, :-1]], 1)
    value = nz & inside
    run_start = ~nz & inside & prev_nz
    # run length: distance to the next nonzero
    nxt = torch.where(nz, pos, 64).flip(1).cummin(1).values.flip(1)
    emit = value.to(torch.int64) + 2 * run_start.to(torch.int64)
    start = emit.cumsum(1) - emit
    counts = emit.sum(1) + 1
    tokens = torch.zeros((N, 129), dtype=torch.int64, device=x.device)
    tokens.scatter_(1, torch.where(value, start, 128), torch.where(value, x, 0))
    tokens.scatter_(1, torch.where(run_start, start + 1, 128), torch.where(run_start, nxt - pos, 0))
    tokens[torch.arange(N, device=x.device), counts - 1] = eob
    return tokens[:, :128], counts


def zerorun_blocks(tokens: torch.Tensor, counts: torch.Tensor, eob: int = EOB):
    """Inverse of :func:`zerorun_tokens`. Returns (``[N, 64]`` int64, ``[N]``
    bool: the block is well formed — it ends at an ``eob`` and fits 64)."""
    t = tokens.to(torch.int64)
    N, S = t.shape
    pos = torch.arange(S, device=t.device)[None, :]
    valid = pos < counts[:, None]
    marker = (t == 0) & valid
    runlen = torch.cat([torch.zeros((N, 1), dtype=torch.bool, device=t.device), marker[:, :-1]], 1) & valid
    is_eob = (t == eob) & valid & ~runlen
    value = valid & ~marker & ~runlen & ~is_eob
    step = torch.where(runlen, t, value.to(torch.int64))
    at = step.cumsum(1) - step
    out = torch.zeros((N, 65), dtype=torch.int64, device=t.device)
    out.scatter_(1, torch.where(value & (at < 64) & (at >= 0), at, 64), torch.where(value, t, 0))
    last = (counts - 1).clamp(0, S - 1)
    ends_eob = t.gather(1, last[:, None])[:, 0] == eob
    one_eob = is_eob.sum(1) == 1
    fits = (step * valid).sum(1) <= 64
    return out[:, :64], ends_eob & one_eob & fits & (counts >= 1)


def token_histogram(tokens: torch.Tensor, counts: torch.Tensor, lo: int, hi: int) -> np.ndarray:
    valid = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < counts[:, None]
    v = tokens[valid]
    v = v[(v >= lo) & (v < hi)] - lo
    return torch.bincount(v, minlength=hi - lo).cpu().numpy().astype(np.int64)


def token_range(tokens: torch.Tensor, counts: torch.Tensor) -> tuple[int, int]:
    valid = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < counts[:, None]
    v = tokens[valid]
    return int(v.min()), int(v.max())


def alphabet(mn: int, mx: int, margin: int = 20, bucket: int = 64) -> tuple[int, int]:
    """The course codec's alphabet around the trained range: the bounds
    widened by 20 and rounded out to multiples of 64, ``[lo, hi)``."""
    lo = math.floor((mn - margin) / bucket) * bucket
    hi = math.ceil((mx + margin + 1) / bucket) * bucket
    return lo, hi


# ------------------------------------------------------------------ Huffman


def huffman_lengths(weights) -> np.ndarray:
    """Optimal prefix-code lengths of positive weights by van Leeuwen's
    two-queue method: leaves in ascending order of weight (ties by index)
    in one queue, merged nodes in the order made in the other, each step
    merging the two lightest heads, a leaf before a node of equal weight.
    Every optimal code has the same cost on its own weights; the fixed tie
    rule makes the lengths, and so the cost on other data, well defined."""
    w = np.asarray(weights, dtype=np.float64)
    n = w.size
    if n == 1:
        return np.ones(1, dtype=np.int64)
    order = np.argsort(w, kind="stable")
    leaf = w[order].tolist()
    parent = [0] * (2 * n - 1)
    node_w: list[float] = []
    li = ni = 0
    for k in range(n - 1):
        picked = []
        for _ in range(2):
            if li < n and (ni >= len(node_w) or leaf[li] <= node_w[ni]):
                picked.append((li, leaf[li]))
                li += 1
            else:
                picked.append((n + ni, node_w[ni]))
                ni += 1
        for i, _ in picked:
            parent[i] = n + k
        node_w.append(picked[0][1] + picked[1][1])
    depth = [0] * (2 * n - 1)
    for i in range(2 * n - 3, -1, -1):
        depth[i] = depth[parent[i]] + 1
    out = np.empty(n, dtype=np.int64)
    out[order] = depth[:n]
    return out


def limit_lengths(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """Shorten a Huffman code to ``max_len`` bits by the procedure of JPEG's
    Annex K.3 (``Adjust_BITS``) on the per-length counts, then deal the
    lengths again to the symbols in their old order of length."""
    lengths = np.asarray(lengths, dtype=np.int64)
    top = int(lengths.max())
    if top <= max_len:
        return lengths
    bits = np.bincount(lengths, minlength=top + 1)
    for i in range(top, max_len, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    out = np.empty_like(lengths)
    out[np.argsort(lengths, kind="stable")] = np.repeat(np.arange(top + 1), bits)[: lengths.size]
    return out


def canonical_code(lengths) -> dict:
    """Canonical code of per-symbol lengths: symbols ranked by (length,
    index) take consecutive code values. Returns the decoder's view: for
    each length its first code, its count and where its symbols start in
    the ranked list, and the ranked list."""
    lengths = np.asarray(lengths, dtype=np.int64)
    top = int(lengths.max())
    count = np.bincount(lengths, minlength=top + 1)
    count[0] = 0
    first = np.zeros(top + 1, dtype=np.int64)
    code = 0
    for length in range(1, top + 1):
        code = (code + count[length - 1]) << 1
        first[length] = code
    ranked = np.lexsort((np.arange(lengths.size), lengths))
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    return {"first": first, "count": count, "start": start, "ranked": ranked,
            "min_len": int(lengths.min()), "max_len": top}


def smoothed_pmf(hist: np.ndarray) -> np.ndarray:
    """The course codec's training pmf: frequencies plus 1e-9, renormalised."""
    p = np.asarray(hist, dtype=np.float64)
    p = p / p.sum() + 1e-9
    return p / p.sum()


def frame_code_lengths(hist: np.ndarray, max_len: int = 26) -> np.ndarray:
    """A per-frame codebook: Huffman over the smoothed pmf of the whole
    alphabet, limited to ``max_len`` bits."""
    return limit_lengths(huffman_lengths(smoothed_pmf(hist)), max_len)


class HotCode:
    """A hot/escape code: the ``K`` most frequent symbols get Huffman codes
    from a ``K + 1``-symbol code whose last symbol is an escape; any other
    symbol costs the escape plus its alphabet index on ``raw_bits`` bits."""

    def __init__(self, lower: int, alphabet_n: int, hot: np.ndarray, lengths: np.ndarray):
        self.lower = int(lower)
        self.alphabet_n = int(alphabet_n)
        self.hot = np.asarray(hot, dtype=np.int64)
        self.lengths = np.asarray(lengths, dtype=np.int64)  # K hot + escape
        self.raw_bits = max(math.ceil(math.log2(max(alphabet_n, 2))), 1)

    @classmethod
    def train(cls, hist: np.ndarray, lower: int, K: int = 127, max_len: int = 16) -> HotCode:
        hist = np.asarray(hist, dtype=np.float64)
        order = np.argsort(-hist, kind="stable")
        hot = order[:K]
        hot = hot[hist[hot] > 0]
        if hot.size == 0:
            hot = order[:1]
        esc = max(float(hist.sum() - hist[hot].sum()), 1e-9 * max(float(hist.sum()), 1.0))
        pmf = np.concatenate([hist[hot], [esc]])
        lengths = limit_lengths(huffman_lengths(pmf / pmf.sum()), max_len)
        return cls(lower, hist.size, hot, lengths)

    def symbol_lengths(self) -> np.ndarray:
        """Coded bits of every alphabet index."""
        out = np.full(self.alphabet_n, self.lengths[-1] + self.raw_bits, dtype=np.int64)
        out[self.hot] = self.lengths[:-1]
        return out


def coded_bits(tokens: torch.Tensor, counts: torch.Tensor, lower: int,
               sym_lengths: np.ndarray) -> torch.Tensor:
    """Bits of each block's tokens under per-symbol code lengths ``[N]``;
    a token outside the alphabet costs 10**9 (no code can carry it)."""
    lens = torch.as_tensor(sym_lengths, dtype=torch.int64, device=tokens.device)
    idx = tokens - lower
    inside = (idx >= 0) & (idx < lens.numel())
    valid = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < counts[:, None]
    cost = torch.where(inside, lens[idx.clamp(0, lens.numel() - 1)], 10**9)
    return torch.where(valid, cost, 0).sum(1)


def train_fused_code(frames: torch.Tensor, tr: Transform, sr: int, eob: int = EOB) -> HotCode:
    """The fixed-codebook codec's training: the hot/escape code of the
    symbols of frame 0 coded intra and of frame 1's residual against frame
    0 (both the source frames, not reconstructions)."""
    H, W = frames.shape[1:]
    planes = [frames[0].to(torch.float64)]
    if frames.shape[0] > 1:
        f0, f1 = frames[0].to(torch.float64), frames[1].to(torch.float64)
        planes.append(f1 - compensate(f0, motion_search(f0, f1, sr), sr))
    toks = [zerorun_tokens(tr.quantise(p), eob) for p in planes]
    mn = min(token_range(t, c)[0] for t, c in toks)
    mx = max(token_range(t, c)[1] for t, c in toks)
    lo, hi = alphabet(mn, mx)
    hist = sum(token_histogram(t, c, lo, hi) for t, c in toks)
    return HotCode.train(hist, lo)
