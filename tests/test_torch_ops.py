"""Parity of the port's tensor ops (ivclab_tpu_torch.ops) with the JAX package.

DCT/IDCT, quantization tables, zero-run coding, hot/escape code mapping,
the grouped packer and the block-parallel decoder, each fed the same
seeded numpy inputs as its JAX twin.
"""

import numpy as np
import pytest
import torch

from torch_parity import DCT_TOL, assert_close, assert_exact, to_torch

import ivclab_tpu.ops.bitpack as jbp
import ivclab_tpu.ops.dct as jdct
import ivclab_tpu.ops.quant as jquant
import ivclab_tpu.ops.transform as jtr
import ivclab_tpu.ops.zerorun as jzr
from ivclab_tpu.entropy.codebook import build_hot_code as j_build_hot_code
from ivclab_tpu.models import intracodec as jintra
from ivclab_tpu.utils import shape as jshape

import ivclab_tpu_torch.ops.bitpack as tbp
import ivclab_tpu_torch.ops.dct as tdct
import ivclab_tpu_torch.ops.quant as tquant
import ivclab_tpu_torch.ops.transform as ttr
import ivclab_tpu_torch.ops.zerorun as tzr
from ivclab_tpu_torch.entropy.stats import histogram_int32 as t_histogram
from ivclab_tpu_torch.models import intracodec as tintra
from ivclab_tpu_torch.utils import shape as tshape
from ivclab_tpu.entropy.stats import histogram_int32 as j_histogram


def _quantized_blocks(rng, n, scale=6.0, zero_frac=0.7):
    """Sparse Laplacian-ish scan-ordered blocks like real quantized symbols."""
    decay = np.exp(-np.arange(64) / 12.0)
    v = np.round(rng.laplace(0.0, scale, (n, 64)) * decay).astype(np.int32)
    v[rng.random((n, 64)) < zero_frac] = 0
    return v


def test_tables_and_matrices_equal():
    for n in (4, 8):
        assert tshape.zigzag_scan_positions(n) == jshape.zigzag_scan_positions(n)
        assert_exact(tshape.zigzag_gather_indices(n), jshape.zigzag_gather_indices(n))
    np.testing.assert_array_equal(tquant.JPEG_LUMINANCE, jquant.JPEG_LUMINANCE)
    np.testing.assert_array_equal(tquant.JPEG_CHROMINANCE, jquant.JPEG_CHROMINANCE)
    np.testing.assert_array_equal(tquant.quant_tables(3), jquant.quant_tables(3))
    for scale in (0.15, 1.0, 2.5):
        np.testing.assert_array_equal(
            tquant.quant_table_zigzag(scale, 3), jquant.quant_table_zigzag(scale, 3)
        )
    np.testing.assert_array_equal(tdct.dct_matrix(8), jdct.dct_matrix(8))
    for zz in (False, True):
        for inv in (False, True):
            np.testing.assert_array_equal(
                tdct.dct2_kron_matrix(8, zz, inv), jdct.dct2_kron_matrix(8, zz, inv)
            )


@pytest.mark.parametrize("n_blocks,seed", [(64, 0), (1020, 1)])
def test_dct_idct_and_quantized_symbols(n_blocks, seed):
    rng = np.random.default_rng(seed)
    pix = (rng.random((n_blocks, 64)) * 255.0).astype(np.float32)
    j_coef = np.asarray(jdct.dct2_fused(pix))
    t_coef = tdct.dct2_fused(to_torch(pix))
    assert_close(t_coef, j_coef, DCT_TOL, "dct2_fused")

    inv = (1.0 / jquant.quant_table_zigzag(1.0, 1)[0]).astype(np.float32)
    j_sym = np.round(j_coef * inv).astype(np.int32)
    t_sym = torch.round(t_coef * to_torch(inv)).to(torch.int32)
    assert_exact(t_sym, j_sym, "quantized symbols")

    coeffs = (rng.integers(-300, 300, (n_blocks, 64))).astype(np.float32)
    assert_close(tdct.idct2_fused(to_torch(coeffs)), jdct.idct2_fused(coeffs),
                 DCT_TOL, "idct2_fused")


def test_require_full_fp32_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    tdct.require_full_fp32()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("cap", [32, 64, 128])
def test_zerorun_encode_counts(cap):
    rng = np.random.default_rng(cap)
    blocks = _quantized_blocks(rng, 300, zero_frac=0.5 if cap == 128 else 0.75)
    blocks[0] = 0                      # all-zero block: just EOB
    blocks[1] = np.arange(1, 65)       # dense block
    blocks[2, ::2] = 0                 # isolated zeros (worst case grammar)
    blocks[2, 1::2] = 3
    assert_exact(tzr.zerorun_counts(to_torch(blocks)), jzr.zerorun_counts(blocks), "counts")
    j_buf, j_valid = jzr.zerorun_encode_blocks_dense(blocks, 64, 4000, cap)
    t_buf, t_valid = tzr.zerorun_encode_blocks_dense(to_torch(blocks), 64, 4000, cap)
    assert_exact(t_buf, j_buf, "buf")
    assert_exact(t_valid, j_valid, "valid_len")


@pytest.mark.parametrize("corrupt", [False, True])
def test_zerorun_decode(corrupt):
    rng = np.random.default_rng(5 + corrupt)
    blocks = _quantized_blocks(rng, 256)
    buf, valid = jzr.zerorun_encode_blocks_dense(blocks, 64, 4000, 128)
    buf, valid = np.asarray(buf).copy(), np.asarray(valid).copy()
    if corrupt:  # hostile symbols: negative/oversize runs, lost EOBs, long counts
        flips = rng.random(buf.shape) < 0.05
        buf[flips] = rng.integers(-70, 90, flips.sum())
        valid[rng.random(valid.shape) < 0.1] = 130
    j_out, j_ok = jzr.zerorun_decode_blocks_dense(buf, valid, 64, 4000)
    t_out, t_ok = tzr.zerorun_decode_blocks_dense(to_torch(buf), to_torch(valid), 64, 4000)
    assert_exact(t_out, j_out, "decoded blocks")
    assert bool(t_ok) == bool(j_ok)
    if not corrupt:
        assert bool(t_ok)
        assert_exact(t_out, blocks, "round trip")


def test_histogram_and_symbol_bounds():
    rng = np.random.default_rng(11)
    vals = rng.integers(-90, 90, (200, 128)).astype(np.int32)
    valid = rng.integers(0, 129, 200).astype(np.int32)
    mask = np.arange(128)[None, :] < valid[:, None]
    assert_exact(t_histogram(to_torch(vals), -64, 64, to_torch(mask)),
                 j_histogram(vals, -64, 64, mask), "histogram_int32")
    assert_exact(t_histogram(to_torch(vals), -40, 70), j_histogram(vals, -40, 70), "no mask")
    assert_exact(ttr.symbol_histogram(to_torch(vals), to_torch(valid), -128, 128),
                 jtr.symbol_histogram(vals, valid, -128, 128), "symbol_histogram")
    j_mn, j_mx = jintra._sym_min_max(vals, valid)
    t_mn, t_mx = tintra._sym_min_max(to_torch(vals), to_torch(valid))
    assert (int(t_mn), int(t_mx)) == (int(j_mn), int(j_mx))
    for mn, mx in [(-3, 5), (-130, 4000), (0, 0), (-64, 63)]:
        assert tintra.bucket_bounds(mn, mx) == jintra.bucket_bounds(mn, mx)


def test_forward_symbolize():
    rng = np.random.default_rng(3)
    img = (rng.random((32, 48, 1)) * 255.0).astype(np.float32)
    inv = (1.0 / jquant.quant_table_zigzag(1.0, 1)).astype(np.float32)
    j_buf, j_valid, j_q = jtr.forward_symbolize(img, inv, 4000)
    t_buf, t_valid, t_q = ttr.forward_symbolize(to_torch(img), to_torch(inv), 4000)
    assert_exact(t_q, j_q, "qsym")
    assert_exact(t_buf, j_buf, "buf")
    assert_exact(t_valid, j_valid, "valid_len")


def _hot_code(rng, alphabet=257, K=127):
    hist = np.floor(1e4 * np.exp(-np.abs(np.arange(alphabet) - alphabet // 2) / 9.0))
    hist += rng.integers(0, 3, alphabet)
    return j_build_hot_code(hist, lower_bound=-(alphabet // 2), K=K)


def _symbol_buffers(rng, code, n, cap):
    """0-based alphabet indices, mostly hot, some escapes, some outside."""
    center = code.alphabet_n // 2
    sym = np.clip(np.round(rng.laplace(center, 10.0, (n, cap))), -5, code.alphabet_n + 5)
    counts = rng.integers(1, cap + 1, n).astype(np.int32)
    return sym.astype(np.int32), counts


def _code_args(code):
    fused = code.fused_table()
    return (np.asarray(code.hot_values), fused[: code.K],
            int(code.code.codes[code.K]), int(code.code.lengths[code.K]), code.raw_bits)


@pytest.mark.parametrize("seed,K", [(0, 127), (1, 20), (2, 1)])
def test_map_codes_hot(seed, K):
    rng = np.random.default_rng(seed)
    code = _hot_code(rng, K=K)
    sym, counts = _symbol_buffers(rng, code, 96, 64)
    hv, hf, esc_code, esc_len, raw_bits = _code_args(code)
    j_codes, j_lens = jtr.map_codes_hot(sym, counts, hv, hf, esc_code, esc_len, raw_bits)
    t_codes, t_lens = ttr.map_codes_hot(to_torch(sym), to_torch(counts), to_torch(hv),
                                        to_torch(hf), esc_code, esc_len, raw_bits)
    assert_exact(t_codes, j_codes, "codes")
    assert_exact(t_lens, j_lens, "lens")
    j_bw, j_gw = jtr.pack_extents(j_lens)
    t_bw, t_gw = ttr.pack_extents(t_lens)
    assert (int(t_bw), int(t_gw)) == (int(j_bw), int(j_gw))


# (words_per_group, block_words): adequate buckets, and buckets too small
# for the content (truncated words, wrapped placement) that must still agree
@pytest.mark.parametrize("gw,bw,cap", [(256, 32, 64), (128, 16, 32), (64, 4, 64)])
def test_pack_locals_decode(gw, bw, cap):
    rng = np.random.default_rng(gw + bw)
    code = _hot_code(rng)
    sym, counts = _symbol_buffers(rng, code, 160, cap)
    hv, hf, esc_code, esc_len, raw_bits = _code_args(code)
    codes, lens = jtr.map_codes_hot(sym, counts, hv, hf, esc_code, esc_len, raw_bits)
    codes, lens = np.asarray(codes), np.asarray(lens)

    j_words, j_gbits, j_offs = jtr.pack_grouped_sized(codes, lens, gw, bw)
    t_words, t_gbits, t_offs = ttr.pack_grouped_sized(to_torch(codes), to_torch(lens), gw, bw)
    assert_exact(t_words, j_words, "group words")
    assert_exact(t_gbits, j_gbits, "group bits")
    assert_exact(t_offs, j_offs, "block offsets")

    lw = min(bw, gw)
    j_local = jbp.locals_from_groups(j_words, j_offs, ttr.PACK_GROUP, lw)
    t_local = tbp.locals_from_groups(t_words, t_offs, ttr.PACK_GROUP, lw)
    assert_exact(t_local, j_local, "local streams")

    c = code.code
    tables = (c.lj_next_minus1, np.asarray(c.first_code, dtype=np.uint32),
              c.group_offset.astype(np.int32), code.alpha_of_rank)
    j_dec = jbp.decode_blocks_hot(j_local, counts, *tables, c.min_len, code.esc_rank,
                                  cap, raw_bits, c.max_len)
    t_dec = tbp.decode_blocks_hot(t_local, to_torch(counts), *tables, c.min_len,
                                  code.esc_rank, cap, raw_bits, c.max_len)
    assert_exact(t_dec, j_dec, "decoded symbols")
    if gw == 256:  # adequate buckets: the decode inverts the map
        ok = np.arange(cap)[None, :] < counts[:, None]
        inside = (sym >= 0) & (sym < code.alphabet_n)
        assert_exact(t_dec.numpy()[ok & inside], sym[ok & inside], "round trip")


def test_decode_blocks_hot_on_random_words():
    """Garbage streams: both decoders must walk them identically."""
    rng = np.random.default_rng(17)
    code = _hot_code(rng, K=40)
    local = rng.integers(0, 2**32, (64, 16), dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, 64, 64).astype(np.int32)
    c = code.code
    tables = (c.lj_next_minus1, np.asarray(c.first_code, dtype=np.uint32),
              c.group_offset.astype(np.int32), code.alpha_of_rank)
    j_dec = jbp.decode_blocks_hot(local, counts, *tables, c.min_len, code.esc_rank,
                                  48, code.raw_bits, c.max_len)
    t_dec = tbp.decode_blocks_hot(to_torch(local), to_torch(counts), *tables, c.min_len,
                                  code.esc_rank, 48, code.raw_bits, c.max_len)
    assert_exact(t_dec, j_dec, "decoded garbage")


def test_locals_rejects_non_power_of_two_groups():
    with pytest.raises(ValueError):
        tbp.locals_from_groups(torch.zeros((2, 48), dtype=torch.int64),
                               torch.zeros(32, dtype=torch.int32), 16, 8)
