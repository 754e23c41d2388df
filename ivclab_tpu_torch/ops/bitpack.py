"""Grouped variable-length bit packing and the block-parallel canonical decoder.

Port of ``ivclab_tpu/ops/bitpack.py`` (``pack_codes_grouped_dense2``,
``locals_from_groups``, ``decode_blocks_hot``).

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

import torch

from ivclab_tpu_torch.entropy.codebook import MAX_CODE_LEN

MASK32 = 0xFFFFFFFF


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def pack_codes_grouped_dense2(codes: torch.Tensor, lens: torch.Tensor, group_size: int,
                              words_per_group: int, block_words: int):
    """Pack per-block codewords into word-aligned group substreams.

    codes/lens: ``[N, S]`` right-aligned codes (< 2^32) and lengths
    (0 = padded slot); N a multiple of ``group_size``. Each block is first
    packed into a private ``block_words``-word buffer, then placed at its
    in-group bit offset. Returns (group_words ``[G, words_per_group]`` int64,
    group_bits ``[G]`` int32, block_offsets ``[N]`` int32 bit offsets into
    the flattened groups).
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
    return torch.as_tensor(x).to(device=device, dtype=torch.int64)


def decode_blocks_hot(local: torch.Tensor, block_sym_counts: torch.Tensor, lj, first_code,
                      group_offset, alpha_of_rank, min_len: int, esc_rank: int,
                      max_syms: int, raw_bits: int, max_len: int | None = None) -> torch.Tensor:
    """Block-parallel canonical decode of hot+escape streams.

    ``local``: ``[B, LW]`` phase-aligned block streams (see
    :func:`locals_from_groups`). All blocks advance one symbol per step:
    the code length comes from the left-justified boundary compares, the
    rank from ``first_code``/``group_offset``, the hot symbol from
    ``alpha_of_rank``, and escapes read their raw ``raw_bits`` payload from
    the window. Each block keeps a bit position into its stream (the JAX
    form shifts a register instead; the windows are the same). Returns
    ``[B, max_syms]`` int32 alphabet indices, zero past each block's count.
    """
    if max_len is None:
        max_len = MAX_CODE_LEN
    dev = local.device
    local = local.to(torch.int64) & MASK32
    B, LW = local.shape
    counts = block_sym_counts.to(device=dev, dtype=torch.int32)
    lj = _as_i64(lj, dev)
    lj = lj[: max_len - 1] if max_len > 1 else lj[:1]
    fc = _as_i64(first_code, dev)[: max_len + 1]
    go = _as_i64(group_offset, dev)[: max_len + 1]
    ar = _as_i64(alpha_of_rank, dev)
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
        raw = torch.where(L < 32, (win << L.clamp(0, 31)) & MASK32, 0) >> (32 - raw_bits)
        value = torch.where(is_esc, raw, val_hot)
        Lt = L + torch.where(is_esc, raw_bits, 0)

        active = i < counts
        out[:, i] = torch.where(active, value, 0).to(torch.int32)
        lu = torch.where(active, Lt, 0) & MASK32
        # a 32-bit advance moves a whole word; longer ones keep their low
        # five bits, as the JAX register shift does
        step = torch.where(lu == 32, 32, lu & 31)
        bitpos = bitpos + step[:, None]
    return out
