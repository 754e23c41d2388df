"""Canonical, length-limited Huffman codebook construction (host, numpy).

Port of ``ivclab_tpu/entropy/codebook.py``. Table construction is
O(alphabet) work and stays on the host (the Huffman depth loop in the C++
engine, ``runtime/native.py``, where there is a ``g++``); the per-symbol
work (encode and decode) runs on tensors (``ivclab_tpu_torch/ops/bitpack.py``).

Design:
- Optimal code lengths via the two-queue Huffman method over sorted
  frequencies.
- Length cap at ``MAX_CODE_LEN`` (32) via the standard count-rebalancing
  algorithm (as used by libjpeg's table generator): smoothed pmfs contain
  1e-9-mass symbols whose unrestricted Huffman depth can exceed 32 bits,
  which would break single-word packing.
- Canonical (DEFLATE-style) code assignment: symbols sorted by
  (length, symbol index) receive consecutive codes. Canonical codes make
  the codebook transmissible as just the length array and make device
  decoding a 32-way comparison + two gathers.

The resulting code lengths are optimal (identical total rate to any Huffman
code for the same pmf) whenever the unrestricted depth fits the cap.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ivclab_tpu_torch.runtime import native
from ivclab_tpu_torch.runtime.trace import span

# format capability: the wire/decoder tables handle lengths up to 32 bits
MAX_CODE_LEN = 32
# construction default: plain canonical codes are length-limited to 26
# bits (libjpeg-style rebalance). Smoothed pmfs put ~1e-9 mass on
# thousands of never-occurring bins, whose Huffman depths reach 27-32 on
# real content; capping them costs zero rate (the long codes are never
# emitted — every occurring symbol has p >= 1/total, far shorter) and
# keeps every code within a fused (code << 6 | len) 32-bit table entry.
BUILD_MAX_LEN = 26


def huffman_code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Optimal prefix-code lengths for positive frequencies (unrestricted).

    Two-queue method: leaves sorted ascending in one queue, merged packages
    appended to a second; each step merges the two globally smallest heads.
    O(n log n) in the sort, O(n) in the merge loop. Ties prefer the leaf,
    which fixes the merge order and so the lengths.
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    n = freqs.size
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    if n == 1:
        return np.ones(1, dtype=np.int32)
    if np.any(freqs <= 0):
        raise ValueError("all frequencies must be positive (smooth the pmf first)")

    order = np.argsort(freqs, kind="stable")
    leaf_w = freqs[order]

    # native fast path: the same merge order and tie-breaking in C++ (a
    # per-frame adaptive encoder builds one tree per frame, putting this
    # loop on the encode path); the numpy loop runs where there is no g++
    depths = native.huffman_depths(leaf_w)
    if depths is None:
        depths = _huffman_depths_np(leaf_w)
    lengths = np.empty(n, dtype=np.int32)
    lengths[order] = depths
    return lengths


def _huffman_depths_np(leaf_w: np.ndarray) -> np.ndarray:
    """Two-queue depths of ascending-sorted positive leaf weights (n >= 2).

    Leaves 0..n-1 (in sorted order) and internal nodes n..2n-2 get parent
    pointers; each step merges the two smallest heads, a leaf winning a tie.
    """
    n = leaf_w.size
    parent = np.full(2 * n - 1, -1, dtype=np.int64)
    pkg_w = np.empty(n - 1, dtype=np.float64)
    li = 0  # next leaf
    pi = 0  # next unconsumed package
    np_pkgs = 0  # packages created

    def take():
        nonlocal li, pi
        # prefer leaf on ties (keeps depths minimal among optimal codes)
        if li < n and (pi >= np_pkgs or leaf_w[li] <= pkg_w[pi]):
            li += 1
            return li - 1, leaf_w[li - 1]
        pi += 1
        return n + pi - 1, pkg_w[pi - 1]

    for k in range(n - 1):
        a, wa = take()
        b, wb = take()
        node = n + k
        parent[a] = node
        parent[b] = node
        pkg_w[k] = wa + wb
        np_pkgs += 1

    depth = np.zeros(2 * n - 1, dtype=np.int32)
    for node in range(2 * n - 3, -1, -1):
        depth[node] = depth[parent[node]] + 1
    return depth[:n]


def limit_code_lengths(lengths: np.ndarray, max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Rebalance a code-length histogram so no length exceeds ``max_len``.

    The classic libjpeg-style adjustment on the per-length symbol counts;
    preserves Kraft equality, then lengths are re-dealt to symbols by
    descending frequency rank (the caller passes lengths already ranked).
    Input and output are per-symbol lengths; symbols keep their relative
    rank ordering (shorter codes to more probable symbols).
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    if lengths.size == 0 or lengths.max(initial=0) <= max_len:
        return lengths
    top = int(lengths.max())
    bits = np.bincount(lengths, minlength=top + 1).astype(np.int64)
    for i in range(top, max_len, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            # move a pair of leaves up: one code at depth i becomes depth i-1,
            # one leaf at depth j splits into two at depth j+1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    # re-deal lengths: sort symbols by original length (frequency rank proxy),
    # stable so equal-probability ties stay deterministic
    rank = np.argsort(lengths, kind="stable")
    new_lengths = np.empty_like(lengths)
    dealt = np.repeat(np.arange(top + 1), bits)
    new_lengths[rank] = dealt[: lengths.size].astype(np.int32)
    return new_lengths


@dataclass(frozen=True)
class CanonicalCode:
    """A canonical Huffman code over a contiguous symbol alphabet.

    ``lower_bound + i`` is the i-th symbol. Encoder tables are indexed by
    ``symbol - lower_bound``; decoder tables follow the canonical
    left-justified layout (see ``ivclab_tpu_torch/ops/bitpack.py``).
    """

    lower_bound: int
    lengths: np.ndarray  # [n] int32, per-symbol code length (>=1)
    codes: np.ndarray  # [n] uint32, right-aligned canonical codes
    # decoder tables
    lj_next_minus1: np.ndarray  # [MAX_CODE_LEN] uint32
    first_code: np.ndarray  # [MAX_CODE_LEN+1] uint32 (index by length)
    group_offset: np.ndarray  # [MAX_CODE_LEN+1] int32
    sorted_syms: np.ndarray  # [n] int32 symbol indices sorted by (len, idx)
    min_len: int  # shortest code length (decode length search starts here)

    @property
    def n(self) -> int:
        return int(self.lengths.size)

    @property
    def max_len(self) -> int:
        return int(self.lengths.max(initial=0))


def canonical_from_lengths(lengths: np.ndarray, lower_bound: int = 0) -> CanonicalCode:
    """Assign canonical codes + build encoder/decoder tables from lengths."""
    lengths = np.asarray(lengths, dtype=np.int32)
    n = lengths.size
    if n and (lengths.min() < 1 or lengths.max() > MAX_CODE_LEN):
        raise ValueError("code lengths must be in [1, 32]")

    bl_count = np.bincount(lengths, minlength=MAX_CODE_LEN + 1).astype(np.uint64)
    bl_count[0] = 0
    first_code = np.zeros(MAX_CODE_LEN + 1, dtype=np.uint64)
    code = np.uint64(0)
    for l in range(1, MAX_CODE_LEN + 1):
        code = (code + bl_count[l - 1]) << np.uint64(1)
        first_code[l] = code

    # canonical order: (length, symbol index)
    sorted_syms = np.lexsort((np.arange(n), lengths)).astype(np.int32)
    group_offset = np.zeros(MAX_CODE_LEN + 1, dtype=np.int64)
    group_offset[1:] = np.cumsum(bl_count.astype(np.int64))[:-1]

    codes = np.zeros(n, dtype=np.uint64)
    rank_in_group = np.zeros(n, dtype=np.uint64)
    # rank within each length group = position in sorted order minus group base
    positions = np.empty(n, dtype=np.int64)
    positions[sorted_syms] = np.arange(n)
    rank_in_group = (positions - group_offset[lengths]).astype(np.uint64)
    codes = first_code[lengths] + rank_in_group

    # left-justified group end boundaries, minus one (uint32 wrap-safe)
    lj_next = np.zeros(MAX_CODE_LEN + 1, dtype=np.uint64)
    for l in range(1, MAX_CODE_LEN + 1):
        lj_next[l] = (first_code[l] + bl_count[l]) << np.uint64(32 - l)
    # boundaries are non-decreasing; empty groups inherit the previous boundary
    for l in range(1, MAX_CODE_LEN + 1):
        if bl_count[l] == 0:
            lj_next[l] = lj_next[l - 1]
    lj_next_minus1 = ((lj_next[1:] - np.uint64(1)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    # Boundary representation: a window has length
    #   min_len + #{L : window > lj_next_minus1[L]}.
    # Empty leading groups (lj_next == 0) and saturated trailing groups
    # (lj_next == 2^32) both wrap to 0xFFFFFFFF, which never satisfies the
    # comparison — exactly the "does not extend the length" sentinel the
    # min_len-based search needs.

    return CanonicalCode(
        lower_bound=int(lower_bound),
        lengths=lengths,
        codes=codes.astype(np.uint32),
        lj_next_minus1=lj_next_minus1,
        first_code=first_code.astype(np.uint32),
        group_offset=group_offset.astype(np.int32),
        sorted_syms=sorted_syms,
        min_len=int(lengths.min()) if n else 1,
    )


def build_canonical_code(pmf: np.ndarray, lower_bound: int = 0, max_len: int = BUILD_MAX_LEN) -> CanonicalCode:
    """pmf -> canonical length-limited code (the full host pipeline)."""
    pmf = np.asarray(pmf, dtype=np.float64)
    if pmf.size == 1:
        return canonical_from_lengths(np.ones(1, dtype=np.int32), lower_bound)
    lengths = huffman_code_lengths(pmf)
    with span("ivc.codebook.limit"):
        lengths = limit_code_lengths(lengths, max_len)
    return canonical_from_lengths(lengths, lower_bound)


@dataclass(frozen=True)
class HotCode:
    """Hot-table + escape canonical Huffman code.

    Every table the coder touches is at most 128 entries wide:

      - the K (<=127) most frequent symbols carry canonical Huffman codes
        (<= ``max_len`` bits) from a K+1-symbol code whose last symbol is
        ESCAPE;
      - every other symbol encodes as ESCAPE + its raw ``raw_bits``-bit
        alphabet index (computable arithmetically — no table at all).

    Rate is within ~1% of the full-alphabet Huffman code on codec streams
    (coverage of the top 127 symbols is ~99.5-100%), often better, because
    concentrating the code tree on the live symbols shortens the hot codes.
    """

    lower_bound: int  # alphabet offset (symbol value = lower_bound + index)
    alphabet_n: int  # full alphabet size (bounds the raw escape field)
    hot_values: np.ndarray  # [K] int32, alphabet indices of the hot symbols
    code: CanonicalCode  # canonical code over K+1 symbols (last = ESCAPE)
    raw_bits: int  # escape payload width
    esc_rank: int  # ESCAPE's canonical (sorted) position
    alpha_of_rank: np.ndarray  # [K+1] int32: canonical rank -> alphabet index

    @property
    def K(self) -> int:
        return int(self.hot_values.size)

    def fused_table(self) -> np.ndarray:
        """[K+1] uint32 (code << 6 | len) including the ESCAPE entry."""
        return (self.code.codes.astype(np.uint32) << 6) | self.code.lengths.astype(np.uint32)

    def mean_len_bound(self) -> int:
        """Max coded length of any symbol (escape incl. raw payload)."""
        esc_len = int(self.code.lengths[self.K])
        return max(int(self.code.lengths.max()), esc_len + self.raw_bits)


def hot_code_from_parts(
    lower_bound: int, alphabet_n: int, hot_values: np.ndarray, lengths: np.ndarray
) -> HotCode:
    """Rebuild a HotCode from its transmissible parts.

    ``lengths`` covers the K hot symbols plus the trailing ESCAPE entry.
    Canonical code assignment depends only on the lengths, so (hot_values,
    lengths, lower_bound, alphabet_n) fully determine the code — this is
    what the container serializes.
    """
    hot = np.asarray(hot_values, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    Ke = hot.size
    if lengths.size != Ke + 1:
        raise ValueError("lengths must cover the hot symbols plus ESCAPE")
    code = canonical_from_lengths(lengths, lower_bound=0)
    raw_bits = max(int(np.ceil(np.log2(max(alphabet_n, 2)))), 1)
    if raw_bits + int(lengths.max()) > 32:
        raise ValueError("escape code + raw payload must fit 32 bits")
    alpha_of_rank = np.zeros(Ke + 1, dtype=np.int32)
    for rank, slot in enumerate(code.sorted_syms):
        alpha_of_rank[rank] = hot[slot] if slot < Ke else 0
    esc_rank = int(np.nonzero(code.sorted_syms == Ke)[0][0])
    return HotCode(
        lower_bound=int(lower_bound),
        alphabet_n=int(alphabet_n),
        hot_values=hot,
        code=code,
        raw_bits=raw_bits,
        esc_rank=esc_rank,
        alpha_of_rank=alpha_of_rank,
    )


def build_hot_code(
    hist: np.ndarray, lower_bound: int = 0, K: int = 127, max_len: int = 16
) -> HotCode:
    """Histogram over the full alphabet -> hot+escape code."""
    hist = np.asarray(hist, dtype=np.float64)
    A = hist.size
    order = np.argsort(-hist, kind="stable")
    hot = order[:K]
    hot = hot[hist[hot] > 0]
    if hot.size == 0:
        hot = order[:1]  # degenerate: empty stream; keep one symbol
    esc_mass = float(hist.sum() - hist[hot].sum())
    pmf = np.concatenate([hist[hot], [max(esc_mass, 1e-9 * max(hist.sum(), 1.0))]])
    pmf = pmf / pmf.sum()
    code = build_canonical_code(pmf, lower_bound=0, max_len=max_len)
    return hot_code_from_parts(lower_bound, A, hot, code.lengths)
