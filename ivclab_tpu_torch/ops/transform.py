"""The transform and entropy-mapping steps of the codec path.

Port of ``ivclab_tpu/ops/transform.py``: ``forward_symbolize`` (pixels ->
zero-run symbol buffers), ``inverse_reconstruct`` (quantized coefficients
-> pixels), ``symbol_histogram``, the full-alphabet Huffman packers of the
intra and adaptive video codecs (``pack_symbols``, one flat stream;
``pack_symbols_grouped``, 16-block word-aligned groups;
``pack_symbols_grouped_sized``, the same with sized buffers), the
hot/escape code mapping ``map_codes_hot`` of the GOP codec, and the
packers' sizing helpers.
"""

from __future__ import annotations

import torch

from ivclab_tpu_torch.entropy.stats import histogram_int32
from ivclab_tpu_torch.ops.bitpack import (
    MASK32,
    pack_codes,
    pack_codes_grouped_dense,
    symbol_bit_layout,
)
from ivclab_tpu_torch.ops.dct import dct2_fused, idct2_fused
from ivclab_tpu_torch.ops.zerorun import BLOCK_CAP, zerorun_encode_blocks
from ivclab_tpu_torch.runtime.trace import span

# Group geometry of the grouped packer: 16 blocks per word-aligned
# substream; worst case 16 blocks x 97 symbols x 32 bits = 1552 words.
PACK_GROUP = 16
GROUP_WORDS = 1600

# Symbol-capacity buckets: a decoder walks the smallest one that holds the
# stream's largest block (its sidecar says which), not the 128-slot worst case.
CAP_SLICES = (32, 48, 64, 96, 128)


def cap_slice(vmax: int, full: int) -> int:
    """Smallest capacity bucket holding ``vmax`` symbols (else ``full``)."""
    for c in CAP_SLICES:
        if c >= vmax and c <= full:
            return c
    return full


def blocks_from_plane(img: torch.Tensor, block: int = 8) -> torch.Tensor:
    """``[H, W, C]`` -> row-major flat blocks ``[hp*wp*C, block*block]``."""
    H, W, C = img.shape
    x = img.reshape(H // block, block, W // block, block, C)
    return x.permute(0, 2, 4, 1, 3).reshape(-1, block * block)


def plane_from_blocks(blocks: torch.Tensor, shape, block: int = 8) -> torch.Tensor:
    """Inverse of :func:`blocks_from_plane`: ``[hp*wp*C, 64]`` -> ``[H, W, C]``."""
    H, W, C = shape
    x = blocks.reshape(H // block, W // block, C, block, block)
    return x.permute(0, 3, 1, 4, 2).reshape(H, W, C)


def forward_symbolize(img_ycbcr: torch.Tensor, inv_qtable_zz: torch.Tensor,
                      eob: int = 4000):
    """YCbCr plane(s) -> zero-run symbol buffers.

    img_ycbcr: ``[H, W, C]`` float32 (H, W multiples of 8);
    inv_qtable_zz: ``[C, 64]`` reciprocal quantization table, scan order.
    Returns (buf ``[N, BLOCK_CAP]`` int32, valid_len ``[N]`` int32,
    qsym ``[N, 64]`` int32 scan-ordered quantized coefficients).
    """
    H, W, C = img_ycbcr.shape
    flat = blocks_from_plane(img_ycbcr.to(torch.float32))
    coeffs = dct2_fused(flat)
    inv = inv_qtable_zz.to(device=coeffs.device, dtype=torch.float32)
    scaled = coeffs.reshape(H // 8, W // 8, C, 64) * inv[None, None]
    qsym = torch.round(scaled).to(torch.int32).reshape(-1, 64)
    buf, valid_len = zerorun_encode_blocks(qsym, 64, eob, BLOCK_CAP)
    return buf, valid_len, qsym


def inverse_reconstruct(qsym: torch.Tensor, qtable_zz: torch.Tensor, shape) -> torch.Tensor:
    """Scan-ordered quantized coefficients ``[N, 64]`` -> YCbCr plane(s)
    ``[H, W, C]``. Dequantization truncates toward zero to int32, as the
    course reference does."""
    H, W, C = shape
    table = qtable_zz.to(device=qsym.device, dtype=torch.float32)
    deq = (qsym.reshape(H // 8, W // 8, C, 64).to(torch.float32) * table[None, None]).to(torch.int32)
    pix = idct2_fused(deq.reshape(-1, 64).to(torch.float32))
    return plane_from_blocks(pix, shape)


def symbol_histogram(buf: torch.Tensor, valid_len: torch.Tensor, lo: int, hi: int):
    """Histogram of the valid symbols over ``[lo, hi)`` (Huffman training)."""
    pos = torch.arange(buf.shape[1], device=buf.device)
    mask = pos[None, :] < valid_len[:, None]
    return histogram_int32(buf, lo, hi, mask=mask)


def _code_table_lookup(buf, valid_len, enc_codes, enc_lens, lower_bound: int):
    """Per-slot (codes, lens) of a full-alphabet code; 0 past each row's
    count. Symbols outside the alphabet clamp to its edge, which is the
    nearest trained symbol because alphabets are contiguous bucketed
    bounds around the training range."""
    dev = buf.device
    cap = buf.shape[1]
    mask = torch.arange(cap, device=dev)[None, :] < valid_len.to(dev)[:, None]
    enc_lens = enc_lens.to(dev)
    idx = (buf.to(torch.int64) - lower_bound).clamp(0, enc_lens.shape[0] - 1)
    lens = torch.where(mask, enc_lens[idx], 0)
    codes = torch.where(mask, enc_codes.to(dev)[idx], 0)
    return codes, lens


def pack_symbols(buf: torch.Tensor, valid_len: torch.Tensor, enc_codes: torch.Tensor,
                 enc_lens: torch.Tensor, num_words: int, lower_bound: int):
    """Huffman-pack per-block symbol buffers into one flat word stream.

    Returns (words ``[num_words]`` int64 32-bit words, total_bits as a 0-d
    tensor, block_bit_offsets ``[N]``). Padded slots encode zero bits, so
    the stream equals the serial encoding of the compacted symbols.
    """
    N, cap = buf.shape
    codes, lens = _code_table_lookup(buf, valid_len, enc_codes, enc_lens, lower_bound)
    off, total = symbol_bit_layout(lens)
    words = pack_codes(codes, lens, off, num_words)
    return words, total, off.reshape(N, cap)[:, 0]


def pack_symbols_grouped(buf: torch.Tensor, valid_len: torch.Tensor, enc_codes: torch.Tensor,
                         enc_lens: torch.Tensor, lower_bound: int):
    """Huffman-pack per-block buffers into word-aligned group substreams.

    ``N`` must be a multiple of PACK_GROUP (pad with empty blocks upstream).
    Returns group_words ``[G, GROUP_WORDS]`` (int64 32-bit words),
    group_bits ``[G]`` (exact payload bits), block_bit_offsets ``[N]`` into
    the flattened groups, and total_bits (the sum of code lengths).
    """
    codes, lens = _code_table_lookup(buf, valid_len, enc_codes, enc_lens, lower_bound)
    group_words, group_bits, block_offsets = pack_codes_grouped_dense(
        codes, lens, PACK_GROUP, GROUP_WORDS)
    return group_words, group_bits, block_offsets, group_bits.to(torch.int64).sum()


# Speculative pack buckets of the per-frame adaptive paths: 1080p content at
# q=1.0 uses up to about 51 words per 16-block group. Callers check the
# buckets held from the returned group bits and offsets (exact whatever the
# word buffers truncate) and re-pack full-stride with pack_symbols_grouped
# where they did not. Callers read these names from this module when they
# run (tests shrink them to force the fallback).
ADAPTIVE_WPG = 128   # words per group
ADAPTIVE_BW = 32     # words per block deposit buffer

# The JAX package's fused (code << 6) | len table holds codes up to this length.
FUSED_TABLE_MAX_LEN = 26


def pack_symbols_grouped_sized(buf: torch.Tensor, valid_len: torch.Tensor,
                               enc_codes: torch.Tensor, enc_lens: torch.Tensor, lower_bound,
                               words_per_group: int, block_words: int,
                               fuse_table: bool = False):
    """Grouped pack into ``words_per_group``-word groups with
    ``block_words``-word block buffers.

    The same group-stream bits and offsets as :func:`pack_symbols_grouped`
    wherever the buckets hold the content; ``lower_bound`` is an int or a
    0-d tensor. ``fuse_table`` is accepted for the JAX signature and
    ignored: there it selects one gather of a fused ``(code << 6) | len``
    table, which halves TPU gathers and gives the same words as the two
    lookups done here. Returns (group_words ``[G, words_per_group]`` int64
    32-bit words, group_bits ``[G]``, block_offsets ``[N]`` at
    ``words_per_group`` stride, total bits as a 0-d tensor).
    """
    del fuse_table
    codes, lens = _code_table_lookup(buf, valid_len, enc_codes, enc_lens, lower_bound)
    group_words, group_bits, block_offsets = pack_codes_grouped_dense(
        codes, lens, PACK_GROUP, words_per_group, block_words)
    return group_words, group_bits, block_offsets, group_bits.to(torch.int64).sum()


def map_codes_hot(buf: torch.Tensor, valid_len: torch.Tensor, hot_values, hot_fused,
                  esc_code: int, esc_len: int, raw_bits: int = 12):
    """Symbol -> (codeword, length) for a hot+escape code.

    ``buf``: ``[N, S]`` 0-based alphabet indices; ``hot_values``: ``[K]``
    alphabet indices of the hot symbols; ``hot_fused``: ``[K]``
    ``(code << 6) | len`` entries. Escape symbols emit
    ``(esc_code << raw_bits) | index`` on ``esc_len + raw_bits`` bits.
    The JAX package compares every symbol against all K hot values; here a
    lookup table over the ``2^raw_bits`` alphabet indices gives the same
    integers (entries of duplicate hot values add, as the compare-and-sum
    does). Hot values must lie in ``[0, 2^raw_bits)``, as every
    :class:`HotCode`'s do.
    Returns (codes ``[N, S]`` int64 < 2^32, lens ``[N, S]`` int32; 0 past
    each row's ``valid_len``).
    """
    if not 1 <= raw_bits <= 24:
        raise ValueError(f"raw_bits {raw_bits} outside [1, 24]")
    dev = buf.device
    sym = buf.to(torch.int64)
    S = sym.shape[1]
    mask = torch.arange(S, device=dev)[None, :] < valid_len.to(dev)[:, None]
    hv = torch.as_tensor(hot_values).to(device=dev, dtype=torch.int64)
    hf = torch.as_tensor(hot_fused).to(device=dev, dtype=torch.int64) & MASK32

    n = 1 << raw_bits
    lut_fused = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(0, hv, hf) & MASK32
    lut_hot = torch.zeros(n, dtype=torch.bool, device=dev)
    lut_hot.index_fill_(0, hv, True)  # a device fill: no host scalar is copied
    in_lut = (sym >= 0) & (sym < n)
    slot = torch.where(in_lut, sym, 0)
    is_hot = in_lut & lut_hot[slot]
    fused = torch.where(is_hot, lut_fused[slot], 0)

    esc_full_code = ((int(esc_code) << raw_bits) | (sym & MASK32)) & MASK32
    codes = torch.where(is_hot, fused >> 6, esc_full_code)
    lens = torch.where(mask, torch.where(is_hot, fused & 63, int(esc_len) + raw_bits), 0)
    return codes, lens.to(torch.int32)


def pack_grouped_sized(codes: torch.Tensor, lens: torch.Tensor, words_per_group: int,
                       block_words: int):
    """Grouped pack with explicitly sized group and block word buffers."""
    with span("ivc.pack.deposit", codes.device):
        return pack_codes_grouped_dense(codes, lens, PACK_GROUP, words_per_group, block_words)


def pack_extents(lens: torch.Tensor):
    """(max block words, max group words) for sizing the pack buffers."""
    block_bits = lens.sum(dim=1)
    bw = (block_bits.max() + 31) // 32
    G = lens.shape[0] // PACK_GROUP
    gw = (block_bits.reshape(G, PACK_GROUP).sum(dim=1).max() + 31) // 32
    return bw, gw
