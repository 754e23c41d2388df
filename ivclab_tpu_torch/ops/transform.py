"""The transform and entropy-mapping steps of the codec path.

Port of the parts of ``ivclab_tpu/ops/transform.py`` the fused GOP codec
uses: ``forward_symbolize`` (pixels -> zero-run symbol buffers, for
codebook training), ``symbol_histogram``, the hot/escape code mapping
``map_codes_hot``, and the grouped packer's sizing helpers.
"""

from __future__ import annotations

import torch

from ivclab_tpu_torch.entropy.stats import histogram_int32
from ivclab_tpu_torch.ops.bitpack import MASK32, pack_codes_grouped_dense2
from ivclab_tpu_torch.ops.dct import dct2_fused
from ivclab_tpu_torch.ops.zerorun import BLOCK_CAP, zerorun_encode_blocks_dense

# Blocks per word-aligned group substream of the grouped packer.
PACK_GROUP = 16


def blocks_from_plane(img: torch.Tensor, block: int = 8) -> torch.Tensor:
    """``[H, W, C]`` -> row-major flat blocks ``[hp*wp*C, block*block]``."""
    H, W, C = img.shape
    x = img.reshape(H // block, block, W // block, block, C)
    return x.permute(0, 2, 4, 1, 3).reshape(-1, block * block)


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
    buf, valid_len = zerorun_encode_blocks_dense(qsym, 64, eob, BLOCK_CAP)
    return buf, valid_len, qsym


def symbol_histogram(buf: torch.Tensor, valid_len: torch.Tensor, lo: int, hi: int):
    """Histogram of the valid symbols over ``[lo, hi)`` (Huffman training)."""
    pos = torch.arange(buf.shape[1], device=buf.device)
    mask = pos[None, :] < valid_len[:, None]
    return histogram_int32(buf, lo, hi, mask=mask)


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
    lut_hot[hv] = True
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
    return pack_codes_grouped_dense2(codes, lens, PACK_GROUP, words_per_group, block_words)


def pack_extents(lens: torch.Tensor):
    """(max block words, max group words) for sizing the pack buffers."""
    block_bits = lens.sum(dim=1)
    bw = (block_bits.max() + 31) // 32
    G = lens.shape[0] // PACK_GROUP
    gw = (block_bits.reshape(G, PACK_GROUP).sum(dim=1).max() + 31) // 32
    return bw, gw
