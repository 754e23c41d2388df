"""Grouped variable-length bit packing and the block-parallel canonical decoder.

Port of ``ivclab_tpu/ops/bitpack.py``: the flat packer (``symbol_bit_layout``,
``pack_codes``), the grouped packer (``pack_codes_grouped_dense``, which
also stands for the JAX package's ``pack_codes_grouped_dense2``), and the
block-parallel decoders (``decode_blocks_device`` for full canonical codes,
``locals_from_groups`` + ``decode_blocks_hot`` for hot/escape codes).

Both decoders dispatch on the device of their stream: CPU tensors walk
the plain PyTorch loops (``decode_blocks_device_plain``,
``decode_blocks_hot_plain``), CUDA tensors the hand-written Hopper
kernels of ``csrc/decode_walk.cu`` (or the call raises), where each
thread walks one block to its own count, so no host read bounds the walk.
The grouped packer dispatches the same way: ``pack_codes_grouped_dense_plain``
on the CPU, the kernel of ``csrc/grouped_pack.cu`` (one warp a group) on a
card.

Bitstream format: MSB-first within big-endian 32-bit words; bit ``k`` of
the stream is bit ``31 - (k mod 32)`` of word ``k // 32``. Blocks are
packed into word-aligned groups of ``group_size`` blocks, each group one
substream of ``words_per_group`` words; a block's bit offset into the
flattened groups is what lets every block decode independently.

Words are held as ``int64`` tensors masked to 32 bits: PyTorch's
``uint32`` lacks shifts, adds and comparisons on the CPU, and ``>>`` on
``int32`` is arithmetic. Callers convert to ``np.uint32`` only at the
container boundary.

The JAX package builds words with one-hot deposits and binary roll chains;
here the same words come from ``scatter_add_`` and gathers. Sums are taken
modulo 2^32 and writes past ``words_per_group`` are dropped, exactly as the
JAX form adds disjoint bit fields and truncates.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ivclab_tpu_torch.entropy.codebook import MAX_CODE_LEN, CanonicalCode
from ivclab_tpu_torch.runtime.trace import count
from ivclab_tpu_torch.utils.shape import upload

MASK32 = 0xFFFFFFFF

# Launches of the hot/escape walk kernel (``csrc/decode_walk.cu``) made in
# this process by ``decode_blocks_hot_cuda``.
WALK_LAUNCHES = 0
# Launches of the canonical walk kernel (``csrc/decode_walk.cu``) made in
# this process by ``decode_blocks_device_cuda``.
CANON_LAUNCHES = 0
# Calls of the grouped-pack kernel (``csrc/grouped_pack.cu``) made in this
# process by ``pack_codes_grouped_dense_cuda``.
PACK_LAUNCHES = 0
# The most words a group the kernel takes (its ``MAX_WPG``: one warp's
# shared-memory tile of 192 KB); the codecs' groups take 64-2048.
PACK_MAX_GROUP_WORDS = 48 * 1024
# The walk kernels' prefix table has 2^PREFIX_BITS entries (the
# ``PREFIX_BITS`` of ``csrc/decode_walk.cu``); see :func:`prefix_table`.
PREFIX_BITS = 10


def symbol_bit_layout(lens: torch.Tensor):
    """Exclusive prefix sum of code lengths -> (bit_offsets int64, total_bits
    as a 0-d int64 tensor)."""
    lens = lens.reshape(-1).to(torch.int64)
    csum = torch.cumsum(lens, 0)
    total = csum[-1] if lens.numel() else torch.zeros((), dtype=torch.int64, device=lens.device)
    return csum - lens, total


def pack_codes(codes: torch.Tensor, lens: torch.Tensor, bit_offsets: torch.Tensor,
               num_words: int) -> torch.Tensor:
    """Place left-justified codewords into a ``[num_words]`` word stream.

    ``codes``: right-aligned (< 2^32); ``lens``: in [0, 32] (0 = skip, for
    padded slots); ``bit_offsets``: each code's first bit. Each code splits
    into at most two words; parts past ``num_words`` are dropped. Returns
    int64 words masked to 32 bits.
    """
    dev = lens.device
    codes = codes.reshape(-1).to(torch.int64) & MASK32
    lens = lens.reshape(-1).to(torch.int64)
    off = bit_offsets.reshape(-1).to(device=dev, dtype=torch.int64)

    lj = torch.where(lens > 0, (codes << ((32 - lens) & 31)) & MASK32, 0)
    word = off >> 5
    shift = off & 31
    part1 = lj >> shift
    part2 = torch.where(shift == 0, 0, (lj << (32 - shift)) & MASK32)
    # slot num_words is the trash for parts past the stream; a zero-length
    # code adds zero at its own position (sending the padded slots, most of
    # a block buffer, to one trash slot would serialize their atomic adds)
    w1 = torch.where((word >= 0) & (word < num_words), word, num_words)
    w2 = torch.where((word + 1 >= 0) & (word + 1 < num_words), word + 1, num_words)
    words = torch.zeros(num_words + 1, dtype=torch.int64, device=dev)
    words.scatter_add_(0, w1, part1)
    words.scatter_add_(0, w2, part2)
    return words[:num_words] & MASK32


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken modulo 2^32 into the int32 range, as int32 sums wrap."""
    return ((x + (1 << 31)) & MASK32) - (1 << 31)


def _stream_index(w: torch.Tensor, n: int) -> torch.Tensor:
    """The JAX gather's rule for an index into an ``n``-word stream: a
    negative index gets ``n`` added once, then it is clamped to [0, n - 1]."""
    return torch.where(w < 0, w + n, w).clamp(0, n - 1)


def bit_window32(words: torch.Tensor, bitpos: torch.Tensor) -> torch.Tensor:
    """The 32-bit window starting at each ``bitpos`` of an MSB-first stream.

    As JAX's ``bit_window32`` computes it: ``bitpos`` is an int32 (wrapped
    at 2^31), its word ``w = bitpos >> 5`` arithmetic, the second word
    ``min(w + 1, n - 1)``, and both indices follow the gather's rule
    (:func:`_stream_index`): a negative one counts from the stream's end,
    and one outside the stream clamps to its first or last word.
    """
    n = words.shape[0]
    bitpos = _wrap32(bitpos.to(torch.int64))
    w = bitpos >> 5
    sh = bitpos & 31
    w1 = words[_stream_index(w, n)]
    w2 = words[_stream_index((w + 1).clamp(max=n - 1), n)]
    return torch.where(sh == 0, w1, ((w1 << sh) | (w2 >> (32 - sh))) & MASK32)


def decode_tables(code: CanonicalCode, device="cuda"):
    """Decoder tables for :func:`decode_blocks_device`: (lj_next_minus1 [32],
    first_code [33], group_offset [33], sorted_syms [n]) as int64 tensors on
    ``device``, then min_len and max_len as ints. The uploads do not block
    the host (:func:`upload`)."""
    lj, fc, go, ss = (upload(np.asarray(a).astype(np.int64), device) for a in (
        code.lj_next_minus1, code.first_code, code.group_offset, code.sorted_syms))
    return lj, fc, go, ss, int(code.min_len), max(int(code.max_len), 1)


def _canon_tables(tables, device):
    """The tables as int64 tensors on ``device`` and min_len, max_len as ints,
    checked for what both walks take: ``max_len`` in [1, 32] with at least
    that many bounds, 33 first codes and group offsets, ``min_len`` in
    [0, 32], at least one symbol. The bounds are taken modulo 2^32, as the
    format's (and JAX's) uint32 tables hold them."""
    lj, fc, go, ss, min_len, max_len = tables
    lj, fc, go, ss = (_as_i64(x, device).reshape(-1) for x in (lj, fc, go, ss))
    lj = lj & MASK32
    min_len, max_len = int(min_len), int(max_len)
    if not 1 <= max_len <= MAX_CODE_LEN or lj.shape[0] < max_len:
        raise ValueError(f"max_len {max_len} outside [1, {MAX_CODE_LEN}] or past the "
                         f"{lj.shape[0]} boundaries")
    if fc.shape[0] != MAX_CODE_LEN + 1 or go.shape[0] != MAX_CODE_LEN + 1:
        raise ValueError(f"first_code and group_offset need {MAX_CODE_LEN + 1} entries, got "
                         f"{fc.shape[0]} and {go.shape[0]}")
    if not 0 <= min_len <= MAX_CODE_LEN:
        raise ValueError(f"min_len {min_len} outside [0, {MAX_CODE_LEN}]")
    if ss.shape[0] < 1:
        raise ValueError("sorted_syms is empty")
    return lj, fc, go, ss, min_len, max_len


def decode_blocks_device_plain(words: torch.Tensor, block_bit_offsets: torch.Tensor,
                               block_sym_counts: torch.Tensor, tables, max_syms: int,
                               max_count: int | None = None, return_bits: bool = False):
    """Decode every block in parallel from one packed stream, in plain PyTorch.

    ``block_bit_offsets[b]``: block b's first bit (an int32, as in JAX);
    ``block_sym_counts[b]``: the symbols to decode for it (at most
    ``max_syms`` are). ``tables``: :func:`decode_tables`. Returns ``[B,
    max_syms]`` int32 0-based symbol indices, zero past each block's count,
    equal to JAX's ``decode_blocks_device`` on every stream: bit positions
    wrap at 2^31 and words are read by :func:`bit_window32`'s rule.

    All blocks advance one symbol per step. A code's length is ``min_len``
    plus the number of left-justified group boundaries its window exceeds.
    The JAX form compares every window against all 31 boundaries; here only
    the first ``max_len`` are compared: boundaries at lengths past the
    code's longest all equal the one at ``max_len`` (empty groups inherit
    it), so that one comparison counts ``32 - max_len`` times and the
    lengths, and the values, are the same for every window.

    The loop runs to the largest count: ``max_count`` where the caller
    knows it from a host copy of the counts, else read from the counts (a
    synchronisation on a device); the kernel of
    :func:`decode_blocks_device_cuda` needs no such bound. ``return_bits``
    also returns each block's bits walked (``[B]`` int64, unwrapped), what
    ``utils/timing.py::canon_walk_bound`` charges for its reads.
    """
    dev = words.device
    lj, fc, go, ss, min_len, max_len = _canon_tables(tables, dev)
    words = words.reshape(-1).to(torch.int64) & MASK32
    bitpos = _wrap32(block_bit_offsets.to(device=dev, dtype=torch.int64).reshape(-1))
    counts = block_sym_counts.to(device=dev, dtype=torch.int64).reshape(-1)
    lj_head = lj[: max_len - 1]
    lj_tail = lj[max_len - 1]
    tail_weight = MAX_CODE_LEN - max_len
    n_sym = ss.shape[0]
    B = bitpos.shape[0]

    out = torch.zeros((B, max_syms), dtype=torch.int32, device=dev)
    bits = torch.zeros(B, dtype=torch.int64, device=dev)
    if max_count is None:
        max_count = int(counts.max()) if B else 0
    n_steps = min(max_count, max_syms) if B else 0
    if n_steps > 0 and words.shape[0] == 0:
        raise ValueError("an empty stream has no words to walk")
    for i in range(n_steps):
        win = bit_window32(words, bitpos)
        L = min_len + (win[:, None] > lj_head[None, :]).sum(dim=1)
        if tail_weight:
            L = L + tail_weight * (win > lj_tail)
        # u32 shift: amounts of 32 and more (lengths 0 and past 32) give 0
        code_val = torch.where((L >= 1) & (L <= 32), win >> (32 - L).clamp(0, 31), 0)
        Lc = L.clamp(max=MAX_CODE_LEN)  # the JAX gathers clamp their index
        d = (code_val - fc[Lc]) & MASK32
        rank = torch.where(d >= 1 << 31, d - (1 << 32), d)  # u32 -> int32
        idx = _wrap32(go[Lc] + rank)  # int32 wrap, as in JAX
        sym = ss[idx.clamp(0, n_sym - 1)]
        active = i < counts
        out[:, i] = torch.where(active, sym, 0).to(torch.int32)
        step = torch.where(active, L, 0)
        bitpos = _wrap32(bitpos + step)
        bits += step
    return (out, bits) if return_bits else out


def prefix_table(bounds, weights, bits: int = PREFIX_BITS):
    """The prefix table by which both walk kernels (``csrc/decode_walk.cu``)
    count the boundaries a window exceeds, stated in plain PyTorch.

    A window ``win`` in [0, 2^32) counts ``weights[k]`` for each boundary
    ``bounds[k]`` (int64, any values: unsorted, repeated, negative or past
    2^32) with ``win > bounds[k]``. Prefix ``p`` holds the windows [lo, hi)
    = [p << s, (p + 1) << s), s = 32 - ``bits``. A boundary ``v`` flips its
    compare between the windows v and v + 1, so over [lo, hi) the count is
    constant, the weight of the boundaries below lo, unless some boundary
    lies in [lo, hi - 2]: those are the prefix's inner boundaries, and a
    window there adds the weight of those it exceeds. Returns (base
    ``[2^bits]``, first ``[2^bits]``, count ``[2^bits]``, inner bounds
    ``[m]``, inner weights ``[m]``) as int64 CPU tensors: prefix ``p``'s
    inner boundaries are entries ``first[p]`` to ``first[p] + count[p] - 1``,
    in the order of their index, as the kernels lay them out.
    """
    v = torch.as_tensor(bounds).to(torch.int64).reshape(-1).cpu()
    w = torch.as_tensor(weights).to(torch.int64).reshape(-1).cpu()
    s = 32 - bits
    lo = torch.arange(1 << bits, dtype=torch.int64)[:, None] << s
    hi = lo + (1 << s)
    below = v[None, :] < lo
    inner = (v[None, :] >= lo) & (v[None, :] <= hi - 2) & (w[None, :] != 0)
    base = (below * w[None, :]).sum(dim=1)
    count = inner.sum(dim=1)
    first = torch.cumsum(count, 0) - count
    _, k_of = torch.nonzero(inner, as_tuple=True)  # by prefix, then index
    return base, first, count, v[k_of], w[k_of]


def prefix_count(win: torch.Tensor, table) -> torch.Tensor:
    """The weight of the boundaries each window exceeds, as the kernels
    count it from a :func:`prefix_table`: the prefix's base, plus a compare
    against each inner boundary of the window's prefix."""
    base, first, count, inner_v, inner_w = table
    bits = base.shape[0].bit_length() - 1
    win = torch.as_tensor(win).to(torch.int64).cpu()
    p = win >> (32 - bits)
    past = base[p]
    for j in range(int(count.max()) if count.numel() else 0):
        k = (first[p] + j).clamp(max=max(inner_v.shape[0] - 1, 0))
        hit = (j < count[p]) & (win > inner_v[k])
        past = past + torch.where(hit, inner_w[k], 0)
    return past


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def pack_codes_grouped_dense_plain(codes: torch.Tensor, lens: torch.Tensor, group_size: int = 16,
                                   words_per_group: int = 1600, block_words: int = 128):
    """Pack per-block codewords into word-aligned group substreams.

    codes/lens: ``[N, S]`` right-aligned codes (< 2^32) and lengths
    (0 = padded slot); N a multiple of ``group_size``. Each block is first
    packed into a private ``block_words``-word buffer, then placed at its
    in-group bit offset. Returns (group_words ``[G, words_per_group]`` int64,
    group_bits ``[G]`` int32, block_offsets ``[N]`` int32 bit offsets into
    the flattened groups). The one counterpart of the JAX package's
    ``pack_codes_grouped_dense`` (the format's fixed sizes, the defaults:
    128-word block buffers >= 97 symbols x 32 bits) and
    ``pack_codes_grouped_dense2`` (buffers sized by the caller); both use
    the same deposit, phase shift and power-of-two placement arena.
    """
    N, S = lens.shape
    G = N // group_size
    BW = block_words
    dev = lens.device
    lens = lens.to(torch.int64)
    codes = codes.to(torch.int64) & MASK32

    csum = torch.cumsum(lens, dim=1)
    off = csum - lens
    block_bits = csum[:, -1]

    lj = torch.where(lens > 0, (codes << ((32 - lens) & 31)) & MASK32, 0)
    word = off >> 5
    sh = off & 31
    p1 = lj >> sh
    p2 = torch.where(sh == 0, 0, (lj << (32 - sh)) & MASK32)

    # per-block deposit over the first max-slots columns; column BW is trash
    slots_used = (lens > 0).sum(dim=1).max()
    col_ok = (torch.arange(S, device=dev) < slots_used)[None, :]
    acc = torch.zeros((N, BW + 1), dtype=torch.int64, device=dev)
    acc.scatter_add_(1, torch.where(col_ok & (word < BW), word, BW), p1)
    acc.scatter_add_(1, torch.where(col_ok & (word + 1 < BW), word + 1, BW), p2)
    acc = acc[:, :BW] & MASK32

    Lg = block_bits.reshape(G, group_size)
    O = torch.cumsum(Lg, dim=1) - Lg  # in-group bit offsets
    group_bits = Lg.sum(dim=1)

    # phase shift: each block's bits move right by O & 31 within its words
    shp = (O & 31).reshape(N, 1)
    acc_prev = torch.cat([torch.zeros((N, 1), dtype=torch.int64, device=dev), acc[:, :-1]], 1)
    shifted = torch.where(shp == 0, acc, ((acc >> shp) | (acc_prev << (32 - shp))) & MASK32)
    spill = torch.where(shp == 0, 0, (acc[:, -1:] << (32 - shp)) & MASK32)
    shifted = torch.cat([shifted, spill], 1)  # [N, BW + 1]

    # placement at word offset O >> 5, modulo the power-of-two arena the
    # JAX roll chain uses, truncated at words_per_group (column wpg: trash)
    pad_w = _next_pow2(words_per_group + BW + 2)
    P = (O >> 5).reshape(N, 1)
    tgt = (P + torch.arange(BW + 1, device=dev)[None, :]) & (pad_w - 1)
    tgt = torch.where(tgt < words_per_group, tgt, words_per_group)
    row = (torch.arange(N, device=dev) // group_size)[:, None] * (words_per_group + 1)
    out = torch.zeros(G * (words_per_group + 1), dtype=torch.int64, device=dev)
    out.scatter_add_(0, (row + tgt).reshape(-1), shifted.reshape(-1))
    out = out.reshape(G, words_per_group + 1)[:, :words_per_group] & MASK32

    base = (torch.arange(G, device=dev, dtype=torch.int64) * (words_per_group * 32))[:, None]
    block_offsets = (base + O).reshape(-1)
    return out, group_bits.to(torch.int32), block_offsets.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _pack_lib():
    from ivclab_tpu_torch.runtime import cuda_build

    lib = cuda_build.load("grouped_pack")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ivc_pack_grouped.argtypes = [vp, vp, i, ll, i, i, i, i, vp, vp, vp, vp, vp]
    lib.ivc_pack_grouped.restype = i
    lib.ivc_pack_grouped_parts.argtypes = []
    lib.ivc_pack_grouped_parts.restype = i
    u = ctypes.c_uint
    lib.ivc_map_gop_hot.argtypes = [vp, ll, i, vp, vp, i, i, i, u, i, i, vp, vp, vp, vp, vp, vp,
                                    vp, vp]
    lib.ivc_map_gop_hot.restype = i
    lib.parts = lib.ivc_pack_grouped_parts()  # scratch ints past one a group
    return lib


def pack_codes_grouped_dense_cuda(codes: torch.Tensor, lens: torch.Tensor, group_size: int = 16,
                                  words_per_group: int = 1600, block_words: int = 128):
    """Launch the Hopper grouped-pack kernel (``csrc/grouped_pack.cu``): what
    :func:`pack_codes_grouped_dense_plain` computes, bit for bit, one warp
    per group.

    ``codes`` and ``lens`` must be ``[N, S]`` integer CUDA tensors on one
    device, N a positive multiple of ``group_size``, S, ``group_size``,
    ``words_per_group`` and ``block_words`` at least 1, ``words_per_group``
    at most :data:`PACK_MAX_GROUP_WORDS`; lengths in [0, 32].
    Contiguous int64 codes and int32 or int64 lengths are used in place.
    Raises on anything else and on a launch error. Runs on the current
    stream without synchronising; counted in :data:`PACK_LAUNCHES` and the
    recorder's ``pack_kernel``.
    """
    global PACK_LAUNCHES
    if not codes.is_cuda:
        raise ValueError(f"needs CUDA codes, got a tensor on {codes.device}")
    dev = codes.device
    if lens.device != dev:
        raise ValueError(f"lens must be on {dev}, got {lens.device}")
    for name, x in (("codes", codes), ("lens", lens)):
        if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool:
            raise ValueError(f"{name} must be an integer tensor, got {x.dtype}")
    if lens.dim() != 2 or codes.shape != lens.shape:
        raise ValueError(f"codes and lens must be one [N, S] shape, got {tuple(codes.shape)} "
                         f"and {tuple(lens.shape)}")
    N, S = lens.shape
    gs, wpg, bw = int(group_size), int(words_per_group), int(block_words)
    if N < 1 or S < 1 or gs < 1 or N % gs:
        raise ValueError(f"N={N} must be a positive multiple of group_size={gs}, S={S} >= 1")
    if not (1 <= wpg <= PACK_MAX_GROUP_WORDS and 1 <= bw < 2**31 and S < 2**26):
        raise ValueError(f"words_per_group={wpg} must lie in [1, {PACK_MAX_GROUP_WORDS}], "
                         f"block_words={bw} in [1, 2^31), S={S} below 2^26")
    codes = codes.to(torch.int64).contiguous()
    if lens.dtype not in (torch.int32, torch.int64):
        lens = lens.to(torch.int32)
    lens = lens.contiguous()
    G = N // gs
    words = torch.empty((G, wpg), dtype=torch.int64, device=dev)
    group_bits = torch.empty(G, dtype=torch.int32, device=dev)
    block_offsets = torch.empty(N, dtype=torch.int32, device=dev)
    lib = _pack_lib()
    scratch = torch.empty(G + lib.parts, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ivc_pack_grouped(codes.data_ptr(), lens.data_ptr(), lens.element_size(), N, S, gs,
                              wpg, bw, words.data_ptr(), group_bits.data_ptr(),
                              block_offsets.data_ptr(), scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"grouped pack kernel refused or failed (cudaError {rc}): N={N}, "
                           f"S={S}, group_size={gs}, words_per_group={wpg}, block_words={bw}")
    PACK_LAUNCHES += 1
    count("pack_kernel")
    return words, group_bits, block_offsets


def pack_codes_grouped_dense(codes: torch.Tensor, lens: torch.Tensor, group_size: int = 16,
                             words_per_group: int = 1600, block_words: int = 128):
    """The grouped packer (see :func:`pack_codes_grouped_dense_plain` for
    what it returns): CUDA tensors launch the kernel through
    :func:`pack_codes_grouped_dense_cuda`, CPU tensors run the plain
    version."""
    pack = (pack_codes_grouped_dense_cuda if codes.is_cuda or lens.is_cuda
            else pack_codes_grouped_dense_plain)
    return pack(codes, lens, group_size, words_per_group, block_words)


def locals_from_groups(group_words: torch.Tensor, block_bit_offsets: torch.Tensor,
                       group_size: int, local_words: int) -> torch.Tensor:
    """Per-block phase-aligned local streams.

    For each block, the ``local_words`` words of its group starting at its
    word offset (wrapping around the group, as the JAX roll does), shifted
    by the bit phase so the block's first code starts at bit 31 of word 0.

    group_words: ``[G, W]`` (W a power of two); block_bit_offsets:
    ``[G * group_size]`` bit offsets into the flattened stream. Returns
    ``[G * group_size, min(local_words, W)]`` int64.
    """
    G, W = group_words.shape
    if W & (W - 1):
        raise ValueError("words_per_group must be a power of two")
    dev = group_words.device
    lw = min(local_words, W)
    words = group_words.to(torch.int64).reshape(-1)
    offs = block_bit_offsets.to(device=dev, dtype=torch.int64).reshape(G, group_size)
    in_group = offs - (torch.arange(G, device=dev, dtype=torch.int64) * (W * 32))[:, None]
    P = (in_group >> 5).reshape(-1, 1)
    idx = (P + torch.arange(lw, device=dev)[None, :]) & (W - 1)
    base = (torch.arange(G, device=dev) * W).repeat_interleave(group_size)[:, None]
    local = words[base + idx]

    B = G * group_size
    phase = (in_group.reshape(B) & 31)[:, None]
    nxt = torch.cat([local[:, 1:], torch.zeros((B, 1), dtype=torch.int64, device=dev)], 1)
    return torch.where(phase == 0, local, ((local << phase) | (nxt >> (32 - phase))) & MASK32)


def _as_i64(x, device) -> torch.Tensor:
    """A tensor as int64 on ``device``; a host array (or list) through
    :func:`upload`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return upload(np.asarray(x).astype(np.int64), device)


def _hot_tables(lj, first_code, group_offset, alpha_of_rank, max_len, device):
    """The walk's tables as int64 tensors on ``device``, cut to ``max_len``
    (None: :data:`MAX_CODE_LEN`), and ``max_len``."""
    if max_len is None:
        max_len = MAX_CODE_LEN
    lj = _as_i64(lj, device)
    lj = lj[: max_len - 1] if max_len > 1 else lj[:1]
    fc = _as_i64(first_code, device)[: max_len + 1]
    go = _as_i64(group_offset, device)[: max_len + 1]
    return lj, fc, go, _as_i64(alpha_of_rank, device), max_len


def decode_blocks_hot_plain(local: torch.Tensor, block_sym_counts: torch.Tensor, lj, first_code,
                            group_offset, alpha_of_rank, min_len: int, esc_rank: int,
                            max_syms: int, raw_bits: int, max_len: int | None = None,
                            return_bits: bool = False):
    """Block-parallel canonical decode of hot+escape streams, in plain PyTorch.

    ``local``: ``[B, LW]`` phase-aligned block streams (see
    :func:`locals_from_groups`). All blocks advance one symbol per step:
    the code length comes from the left-justified boundary compares, the
    rank from ``first_code``/``group_offset``, the hot symbol from
    ``alpha_of_rank``, and escapes read their raw ``raw_bits`` payload from
    the window. Each block keeps a bit position into its stream (the JAX
    form shifts a register instead; the windows are the same). Returns
    ``[B, max_syms]`` int32 alphabet indices, zero past each block's count.
    The loop runs to the largest count, which it reads from the device;
    the kernel of :func:`decode_blocks_hot_cuda` needs no such bound.
    ``return_bits`` also returns each block's bits walked (``[B]`` int64),
    what ``utils/timing.py::decode_walk_bound`` charges for its reads.
    """
    dev = local.device
    local = local.to(torch.int64) & MASK32
    B, LW = local.shape
    counts = block_sym_counts.to(device=dev, dtype=torch.int32)
    lj, fc, go, ar, max_len = _hot_tables(lj, first_code, group_offset, alpha_of_rank, max_len,
                                          dev)
    n_ranks = ar.shape[0]
    min_len = int(min_len)
    esc_rank = int(esc_rank)

    out = torch.zeros((B, max_syms), dtype=torch.int32, device=dev)
    n_steps = min(int(counts.max()), max_syms) if B else 0
    padded = torch.cat([local, torch.zeros((B, 1), dtype=torch.int64, device=dev)], 1)
    bitpos = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    for i in range(n_steps):
        w = bitpos >> 5
        sh = bitpos & 31
        w1 = padded.gather(1, w.clamp(max=LW))
        w2 = padded.gather(1, (w + 1).clamp(max=LW))
        win = torch.where(sh == 0, w1, ((w1 << sh) | (w2 >> (32 - sh))) & MASK32)[:, 0]

        L = min_len + (win[:, None] > lj[None, :]).sum(dim=1)
        in_tab = (L >= 0) & (L <= max_len)
        Lc = L.clamp(0, max_len)
        fcv = torch.where(in_tab, fc[Lc], 0)
        gov = torch.where(in_tab, go[Lc], 0)
        s = 32 - L
        code_val = torch.where((s >= 0) & (s < 32), win >> s.clamp(0, 31), 0)
        d = (code_val - fcv) & MASK32
        rank = gov + torch.where(d >= 1 << 31, d - (1 << 32), d)
        rank = ((rank + (1 << 31)) & MASK32) - (1 << 31)  # int32 wrap, as in JAX
        rank = rank.clamp(0, n_ranks - 1)
        val_hot = ar[rank]
        is_esc = rank == esc_rank
        # u32 shift: lengths outside [0, 32) shift everything out
        raw = torch.where((L >= 0) & (L < 32), (win << L.clamp(0, 31)) & MASK32, 0)
        raw = raw >> (32 - raw_bits)
        value = torch.where(is_esc, raw, val_hot)
        Lt = L + torch.where(is_esc, raw_bits, 0)

        active = i < counts
        out[:, i] = torch.where(active, value, 0).to(torch.int32)
        lu = torch.where(active, Lt, 0) & MASK32
        # a 32-bit advance moves a whole word; longer ones keep their low
        # five bits, as the JAX register shift does
        step = torch.where(lu == 32, 32, lu & 31)
        bitpos = bitpos + step[:, None]
    return (out, bitpos[:, 0]) if return_bits else out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a ``csrc/decode_walk.cu`` build on ``lib``."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ivc_decode_blocks_hot.argtypes = [vp, i, i, vp, vp, i, vp, vp, i, vp, i, i, i, i, i,
                                          vp, vp]
    lib.ivc_decode_blocks_hot.restype = i
    ll = ctypes.c_longlong
    lib.ivc_decode_blocks_device.argtypes = [vp, ll, vp, vp, i, vp, i, vp, vp, vp, ll, i, i, vp,
                                             vp]
    lib.ivc_decode_blocks_device.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _walk_lib():
    from ivclab_tpu_torch.runtime import cuda_build

    return bind(cuda_build.load("decode_walk"))


def decode_blocks_hot_cuda(local: torch.Tensor, block_sym_counts: torch.Tensor, lj, first_code,
                           group_offset, alpha_of_rank, min_len: int, esc_rank: int,
                           max_syms: int, raw_bits: int, max_len: int | None = None
                           ) -> torch.Tensor:
    """Launch the Hopper walk kernel (``csrc/decode_walk.cu``): what
    :func:`decode_blocks_hot_plain` computes, one thread per block, each
    walking to its own count.

    ``local`` and ``block_sym_counts`` must be CUDA tensors on one device
    (``[B, LW]`` words, ``[B]`` counts), and the tables tensors there or
    host arrays; ``raw_bits`` in [1, 32], ``max_len`` in [0, 63] with
    ``max_len + 1`` first-code and group-offset entries, at least one rank.
    Raises on anything else and on a launch error. Runs on the current
    stream without synchronising.
    """
    global WALK_LAUNCHES
    if not local.is_cuda:
        raise ValueError(f"needs a CUDA stream tensor, got one on {local.device}")
    dev = local.device
    if local.dim() != 2:
        raise ValueError(f"local must be [B, LW], got shape {tuple(local.shape)}")
    B, LW = local.shape
    if block_sym_counts.device != dev or block_sym_counts.shape != (B,):
        raise ValueError(f"block_sym_counts must be [{B}] on {dev}, got "
                         f"{tuple(block_sym_counts.shape)} on {block_sym_counts.device}")
    lj, fc, go, ar, max_len = _hot_tables(lj, first_code, group_offset, alpha_of_rank, max_len,
                                          dev)
    if not 0 <= max_len < 64 or fc.shape[0] != max_len + 1 or go.shape[0] != max_len + 1:
        raise ValueError(f"max_len {max_len} needs max_len + 1 <= 64 first-code and "
                         f"group-offset entries, got {fc.shape[0]} and {go.shape[0]}")
    if ar.shape[0] < 1:
        raise ValueError("alpha_of_rank is empty")
    if not 1 <= int(raw_bits) <= 32:
        raise ValueError(f"raw_bits {raw_bits} outside [1, 32]")
    if int(max_syms) < 0:
        raise ValueError(f"max_syms {max_syms} < 0")
    min_len = int(min_len)
    if not -(2**31) <= min_len < 2**31:
        raise ValueError(f"min_len {min_len} does not fit in an int32")
    esc = int(esc_rank)
    esc = esc if 0 <= esc < ar.shape[0] else -1
    local = local.to(torch.int64).contiguous()
    counts = block_sym_counts.to(torch.int32).contiguous()
    lj, fc, go, ar = (x.contiguous() for x in (lj, fc, go, ar))
    out = torch.empty((B, int(max_syms)), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _walk_lib().ivc_decode_blocks_hot(
        local.data_ptr(), B, LW, counts.data_ptr(), lj.data_ptr(), lj.shape[0], fc.data_ptr(),
        go.data_ptr(), max_len, ar.data_ptr(), ar.shape[0], min_len, esc,
        int(max_syms), int(raw_bits), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"decode walk kernel refused or failed (cudaError {rc}): B={B}, "
                           f"LW={LW}, max_syms={max_syms}, max_len={max_len}, "
                           f"{ar.shape[0]} ranks")
    WALK_LAUNCHES += 1
    return out


def decode_blocks_hot(local: torch.Tensor, block_sym_counts: torch.Tensor, lj, first_code,
                      group_offset, alpha_of_rank, min_len: int, esc_rank: int,
                      max_syms: int, raw_bits: int, max_len: int | None = None) -> torch.Tensor:
    """Block-parallel canonical decode of hot+escape streams -> ``[B,
    max_syms]`` int32 alphabet indices, zero past each block's count.

    CPU streams run :func:`decode_blocks_hot_plain`; CUDA streams the
    kernel through :func:`decode_blocks_hot_cuda`, which reads nothing back
    to the host.
    """
    walk = decode_blocks_hot_cuda if local.is_cuda else decode_blocks_hot_plain
    return walk(local, block_sym_counts, lj, first_code, group_offset, alpha_of_rank, min_len,
                esc_rank, max_syms, raw_bits, max_len)


def decode_blocks_device_cuda(words: torch.Tensor, block_bit_offsets: torch.Tensor,
                              block_sym_counts: torch.Tensor, tables, max_syms: int
                              ) -> torch.Tensor:
    """Launch the Hopper canonical walk kernel (``csrc/decode_walk.cu``):
    what :func:`decode_blocks_device_plain` computes, one thread per block,
    each walking to its own count.

    ``words`` (the stream, any shape, 32-bit words in any integer type),
    ``block_bit_offsets`` and ``block_sym_counts`` (``[B]`` each) must be
    CUDA tensors on one device, and the tables (:func:`decode_tables`)
    tensors there or host arrays, with what :func:`decode_blocks_device_plain`
    takes: ``max_len`` in [1, 32], 33 first codes and group offsets,
    ``min_len`` in [0, 32], at least one symbol, and a stream of at least one
    word. Raises on anything else and on a launch error. Runs on the current stream without synchronising.
    """
    global CANON_LAUNCHES
    if not words.is_cuda:
        raise ValueError(f"needs a CUDA stream tensor, got one on {words.device}")
    dev = words.device
    B = block_bit_offsets.reshape(-1).shape[0]
    for name, x in (("block_bit_offsets", block_bit_offsets),
                    ("block_sym_counts", block_sym_counts)):
        if x.device != dev or x.dim() != 1 or x.shape[0] != B:
            raise ValueError(f"{name} must be [{B}] on {dev}, got {tuple(x.shape)} on {x.device}")
    lj, fc, go, ss, min_len, max_len = _canon_tables(tables, dev)
    if int(max_syms) < 0:
        raise ValueError(f"max_syms {max_syms} < 0")
    words = words.reshape(-1).to(torch.int64).contiguous()
    out = torch.empty((B, int(max_syms)), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    if words.shape[0] == 0:
        raise ValueError("an empty stream has no words to walk")
    offs = block_bit_offsets.to(torch.int32).contiguous()
    counts = block_sym_counts.to(torch.int32).contiguous()
    lj, fc, go, ss = (x.contiguous() for x in (lj, fc, go, ss))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _walk_lib().ivc_decode_blocks_device(
        words.data_ptr(), words.shape[0], offs.data_ptr(), counts.data_ptr(), B, lj.data_ptr(),
        max_len, fc.data_ptr(), go.data_ptr(), ss.data_ptr(), ss.shape[0], min_len,
        int(max_syms), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"canonical walk kernel refused or failed (cudaError {rc}): B={B}, "
                           f"{words.shape[0]} words, max_syms={max_syms}, max_len={max_len}, "
                           f"min_len={min_len}, {ss.shape[0]} symbols")
    CANON_LAUNCHES += 1
    return out


def decode_blocks_device(words: torch.Tensor, block_bit_offsets: torch.Tensor,
                         block_sym_counts: torch.Tensor, tables, max_syms: int,
                         max_count: int | None = None) -> torch.Tensor:
    """Decode every block of one packed stream in parallel -> ``[B,
    max_syms]`` int32 0-based symbol indices, zero past each block's count
    (JAX's ``decode_blocks_device``).

    CPU streams run :func:`decode_blocks_device_plain` (to ``max_count``
    steps where given, else to the counts' largest); CUDA streams the
    kernel through :func:`decode_blocks_device_cuda`, which needs no bound
    and reads nothing back to the host.
    """
    if words.is_cuda:
        return decode_blocks_device_cuda(words, block_bit_offsets, block_sym_counts, tables,
                                         max_syms)
    return decode_blocks_device_plain(words, block_bit_offsets, block_sym_counts, tables,
                                      max_syms, max_count)
