"""Parity of the port's still-image intra codec with the JAX package.

The ops of the intra path (stream zero-run coding, the flat and grouped
full-alphabet packers, the block-parallel canonical decoder, the inverse
transform), the IVC1 intra container (both layouts, and its hostile-bytes
checks), and ``IntraCodec`` / ``IntraCodecAdaptive`` end to end, each fed
the same seeded inputs as its JAX twin. Integers and container bytes must
be equal exactly; reconstructions agree within ``RECON_TOL``.
"""

import struct

import numpy as np
import pytest
import torch

from torch_parity import (
    DCT_TOL,
    RECON_TOL,
    assert_close,
    assert_exact,
    to_torch,
)

import ivclab_tpu.ops.bitpack as jbp
import ivclab_tpu.ops.transform as jtr
import ivclab_tpu.ops.zerorun as jzr
import ivclab_tpu.runtime.container as jct
from ivclab_tpu.entropy.codebook import build_canonical_code as j_build_code
from ivclab_tpu.models import IntraCodec as JIntra
from ivclab_tpu.models import IntraCodecAdaptive as JAdaptive
from ivclab_tpu.models import intracodec as jintra
from ivclab_tpu.ops.quant import quant_table_zigzag
from ivclab_tpu.utils import calc_psnr as j_psnr
from ivclab_tpu.utils import fixtures

import ivclab_tpu_torch.ops.bitpack as tbp
import ivclab_tpu_torch.ops.transform as ttr
import ivclab_tpu_torch.ops.zerorun as tzr
import ivclab_tpu_torch.runtime.container as tct
from ivclab_tpu_torch import FusedVideoCodec as TFused
from ivclab_tpu_torch import IntraCodec as TIntra
from ivclab_tpu_torch import IntraCodecAdaptive as TAdaptive
from ivclab_tpu_torch import calc_psnr as t_psnr
from ivclab_tpu_torch.entropy.codebook import build_canonical_code as t_build_code
from ivclab_tpu_torch.models import intracodec as tintra


def _quantized_blocks(rng, n, scale=6.0, zero_frac=0.7):
    decay = np.exp(-np.arange(64) / 12.0)
    v = np.round(rng.laplace(0.0, scale, (n, 64)) * decay).astype(np.int32)
    v[rng.random((n, 64)) < zero_frac] = 0
    v[0] = 0                      # all-zero block: EOB only
    v[1, ::2], v[1, 1::2] = 0, 3  # isolated zeros: the grammar's worst case
    return v


# ------------------------------------------------------------ zero-run


@pytest.mark.parametrize("corrupt", [False, True])
def test_stream_zerorun_matches_jax(corrupt):
    rng = np.random.default_rng(40 + corrupt)
    blocks = _quantized_blocks(rng, 160)
    j_buf, j_valid = jzr.zerorun_encode_blocks(blocks, 64, 4000)
    t_buf, t_valid = tzr.zerorun_encode_blocks(to_torch(blocks), 64, 4000)
    assert_exact(t_buf, j_buf, "buf")
    assert_exact(t_valid, j_valid, "valid_len")
    j_stream, j_total = jzr.compact_symbols(j_buf, j_valid)
    t_stream, t_total = tzr.compact_symbols(t_buf, t_valid)
    assert_exact(t_stream, j_stream, "compact stream")
    assert int(t_total) == int(j_total)

    stream = np.asarray(j_stream).copy()
    total = int(j_total)
    if corrupt:  # lost EOBs, negative and oversize runs
        flips = np.flatnonzero(rng.random(total) < 0.03)
        stream[flips] = rng.integers(-70, 90, flips.size)
    j_out, j_ok = jzr.zerorun_decode_stream(stream, total, 160, 64, 4000)
    t_out, t_ok = tzr.zerorun_decode_stream(to_torch(stream), total, 160, 64, 4000)
    assert bool(t_ok) == bool(j_ok)
    if not corrupt:
        assert bool(t_ok)
        assert_exact(t_out, j_out, "decoded blocks")
        assert_exact(t_out, blocks, "round trip")
    else:
        assert not bool(t_ok)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 70001])
def test_two_level_running_max_equals_cummax(n):
    v = torch.from_numpy(np.random.default_rng(n).integers(-2**31, 2**31, n).astype(np.int32))
    assert torch.equal(tzr._cummax(v), torch.cummax(v, 0).values if n else v)


@pytest.mark.parametrize("corrupt", [False, True])
def test_block_zerorun_decode_matches_jax(corrupt):
    rng = np.random.default_rng(50 + corrupt)
    blocks = _quantized_blocks(rng, 128)
    buf, valid = (np.asarray(a).copy() for a in jzr.zerorun_encode_blocks(blocks, 64, 4000))
    if corrupt:
        buf[rng.random(buf.shape) < 0.04] = 0
        valid[::7] += 3
    j_out, j_ok = jzr.zerorun_decode_blocks(buf, valid, 64, 4000)
    t_out, t_ok = tzr.zerorun_decode_blocks(to_torch(buf), to_torch(valid), 64, 4000)
    assert bool(t_ok) == bool(j_ok) == (not corrupt)
    if not corrupt:
        assert_exact(t_out, j_out, "decoded blocks")


def test_zerorun_coder_facade_matches_jax():
    rng = np.random.default_rng(3)
    coeffs = _quantized_blocks(rng, 4 * 5 * 3).reshape(4, 5, 3, 64)
    t, j = tzr.ZeroRunCoder(), jzr.ZeroRunCoder()
    enc = t.encode(coeffs)
    assert isinstance(enc, np.ndarray)
    assert_exact(enc, j.encode(coeffs), "encoded")
    assert_exact(t.decode(enc, (4, 5, 3)), coeffs, "decoded")
    with pytest.raises(ValueError, match="zero-run decode failed"):
        t.decode(enc, (4, 5, 4))


# ------------------------------------------------------------ bit packing


def test_flat_pack_and_windows_match_jax():
    rng = np.random.default_rng(60)
    n = 4000
    lens = rng.integers(0, 33, n).astype(np.int32)
    lens[rng.random(n) < 0.2] = 0
    codes = (rng.integers(0, 2**32, n, dtype=np.uint64) & ((1 << lens.astype(np.uint64)) - 1)
             ).astype(np.uint32)
    j_off, j_total = jbp.symbol_bit_layout(lens)
    t_off, t_total = tbp.symbol_bit_layout(to_torch(lens))
    assert_exact(t_off, j_off, "bit offsets")
    assert int(t_total) == int(j_total)
    for num_words in ((int(j_total) + 31) // 32, 900):  # the second drops the tail
        j_words = jbp.pack_codes(codes, lens, j_off, num_words)
        t_words = tbp.pack_codes(to_torch(codes), to_torch(lens), t_off, num_words)
        assert_exact(t_words, j_words, f"words ({num_words})")
    pos = np.concatenate([rng.integers(0, int(j_total) + 200, 500), [0, 31, 32, 33]])
    assert_exact(tbp.bit_window32(t_words, to_torch(pos)),
                 jax_windows(j_words, pos), "32-bit windows")


def jax_windows(words, pos):
    import jax

    return jax.vmap(lambda p: jbp.bit_window32(words, p))(np.asarray(pos, dtype=np.int32))


def _codes():
    lap = np.exp(-np.abs(np.arange(301) - 150) / 6.0) + 1e-9
    skew = 2.0 ** -np.arange(40)
    return {
        "laplacian": (lap / lap.sum(), 26),          # max_len < 32
        "skewed": (skew / skew.sum(), 32),           # reaches the 32-bit format limit
        "single": (np.array([1.0]), 26),             # incomplete one-symbol code
    }


@pytest.mark.parametrize("name", list(_codes()))
def test_decode_blocks_device_matches_jax(name):
    pmf, max_len = _codes()[name]
    t_code = t_build_code(pmf, lower_bound=-150, max_len=max_len)
    j_code = j_build_code(pmf, lower_bound=-150, max_len=max_len)
    assert_exact(t_code.lengths, j_code.lengths, "lengths")
    if name == "skewed":
        assert t_code.max_len == 32
    elif name == "laplacian":
        assert t_code.max_len < 32
    rng = np.random.default_rng(70)
    N, cap = 48, 64
    buf = rng.choice(pmf.size, (N, cap), p=pmf).astype(np.int32) - 150
    valid = rng.integers(1, cap + 1, N).astype(np.int32)
    enc_codes, enc_lens = j_code.codes.astype(np.uint32), j_code.lengths.astype(np.int32)
    j_words, j_total, j_offs = jtr.pack_symbols(buf, valid, enc_codes, enc_lens, N * cap, -150)
    t_words, t_total, t_offs = ttr.pack_symbols(
        to_torch(buf), to_torch(valid), to_torch(enc_codes), to_torch(enc_lens), N * cap, -150)
    assert_exact(t_words, j_words, "packed words")
    assert_exact(t_offs, j_offs, "block offsets")
    assert int(t_total) == int(j_total)

    tables = tbp.decode_tables(t_code, device="cpu")
    for max_syms in (cap, 32):
        j_dec = jbp.decode_blocks_device(j_words, j_offs, valid, jbp.decode_tables(j_code), max_syms)
        t_dec = tbp.decode_blocks_device(t_words, t_offs, to_torch(valid), tables, max_syms)
        assert_exact(t_dec, j_dec, f"decoded ({max_syms} slots)")
    inside = np.arange(cap)[None, :] < valid[:, None]
    assert_exact(t_dec.numpy()[inside[:, :32]], (buf[:, :32] + 150)[inside[:, :32]], "round trip")

    # garbage words walk identically, whatever length each window decodes to
    junk = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
    offs = rng.integers(0, 300 * 32, 40).astype(np.int32)
    cnt = rng.integers(0, 60, 40).astype(np.int32)
    assert_exact(tbp.decode_blocks_device(to_torch(junk), to_torch(offs), to_torch(cnt), tables, 60),
                 jbp.decode_blocks_device(junk, offs, cnt, jbp.decode_tables(j_code), 60),
                 "garbage walk")


def test_grouped_packers_match_jax():
    rng = np.random.default_rng(80)
    code = j_build_code(np.exp(-np.abs(np.arange(201) - 100) / 5.0) + 1e-9, lower_bound=-100)
    N, cap = 64, 128
    blocks = _quantized_blocks(rng, N, scale=12.0, zero_frac=0.3)
    buf, valid = (np.asarray(a) for a in jzr.zerorun_encode_blocks(blocks, 64, 4000))
    buf = np.where(buf == 4000, 0, buf).astype(np.int32)
    enc_codes, enc_lens = code.codes.astype(np.uint32), code.lengths.astype(np.int32)
    j_out = jtr.pack_symbols_grouped(buf, valid, enc_codes, enc_lens, -100)
    t_out = ttr.pack_symbols_grouped(to_torch(buf), to_torch(valid), to_torch(enc_codes),
                                     to_torch(enc_lens), -100)
    for got, want, what in zip(t_out, j_out, ("group words", "group bits", "offsets", "total")):
        assert_exact(got, want, what)
    assert tuple(t_out[0].shape) == (N // 16, ttr.GROUP_WORDS)

    lens = np.where(np.arange(cap)[None, :] < valid[:, None], enc_lens[np.clip(buf + 100, 0, 200)], 0)
    codes = np.where(lens > 0, enc_codes[np.clip(buf + 100, 0, 200)], 0).astype(np.uint32)
    j_dense = jbp.pack_codes_grouped_dense(codes, lens, 16, 1600)
    t_dense = tbp.pack_codes_grouped_dense(to_torch(codes), to_torch(lens), 16, 1600)
    for got, want, what in zip(t_dense, j_dense, ("words", "group bits", "offsets")):
        assert_exact(got, want, f"pack_codes_grouped_dense {what}")
    assert ttr.CAP_SLICES == jtr.CAP_SLICES and ttr.GROUP_WORDS == jtr.GROUP_WORDS
    for vmax, full in [(1, 128), (32, 128), (33, 128), (97, 128), (129, 128), (50, 48)]:
        assert ttr.cap_slice(vmax, full) == jtr.cap_slice(vmax, full)


def test_inverse_transform_matches_jax():
    rng = np.random.default_rng(90)
    qsym = _quantized_blocks(rng, 4 * 6 * 3)
    qt = quant_table_zigzag(0.5, 3)
    shape = (32, 48, 3)
    assert_exact(ttr.plane_from_blocks(to_torch(qsym), shape), jtr.plane_from_blocks(qsym, shape),
                 "plane_from_blocks")
    assert_close(ttr.inverse_reconstruct(to_torch(qsym), torch.from_numpy(qt), shape),
                 jtr.inverse_reconstruct(qsym, qt, shape), DCT_TOL, "inverse_reconstruct")
    buf = to_torch(rng.integers(-5, 5, (35, 8)).astype(np.int32))
    valid = to_torch(rng.integers(0, 9, 35).astype(np.int32))
    j = jintra._pad_blocks(np.asarray(buf), np.asarray(valid))
    t = tintra._pad_blocks(buf, valid)
    assert t[2] == j[2] == 35
    assert_exact(t[0], j[0], "padded buf")
    assert_exact(t[1], j[1], "padded counts")


# ------------------------------------------------------------ container


@pytest.fixture(scope="module")
def jax_intra_blob():
    img = (np.random.default_rng(7).random((40, 64, 3)) * 255).astype(np.uint8)
    codec = JIntra(1.0)
    codec.train_huffman_from_image(img)
    return codec.encode_to_container(img)


def test_intra_payload_round_trips_jax_bytes(jax_intra_blob):
    t = tct.IntraPayload.from_bytes(jax_intra_blob)
    j = jct.IntraPayload.from_bytes(jax_intra_blob)
    assert t.to_bytes() == jax_intra_blob
    assert t.container_bytes == len(jax_intra_blob)
    assert (t.kind, t.shape, t.num_symbols, t.payload_bits, t.layout) == (
        j.kind, j.shape, j.num_symbols, j.payload_bits, j.layout)
    for got, want in zip(tct.device_views(t, device="cpu"), jct.device_views(j)):
        assert isinstance(got, torch.Tensor)
        assert_exact(got, np.asarray(want), "device view")
    assert_exact(t.codebook.canonical().codes, j.codebook.canonical().codes, "canonical codes")

    # the contiguous layout, written by both sides
    words = np.random.default_rng(1).integers(0, 2**32, 37, dtype=np.uint64).astype(np.uint32)
    lengths = np.asarray(j.codebook.lengths)
    tp = tct.IntraPayload(tct.KIND_PLANE, (9, 11), 0.5, 4000, 123, 1170,
                          tct.Codebook(-64, lengths), tct.LAYOUT_CONTIGUOUS, words)
    jp = jct.IntraPayload(jct.KIND_PLANE, (9, 11), 0.5, 4000, 123, 1170,
                          jct.Codebook(-64, lengths), jct.LAYOUT_CONTIGUOUS, words)
    assert tp.to_bytes() == jp.to_bytes()
    back = tct.IntraPayload.from_bytes(jp.to_bytes())
    assert back.shape == (9, 11) and back.to_bytes() == jp.to_bytes()
    with pytest.raises(ValueError, match="grouped layout"):
        tct.device_views(back, device="cpu")


def test_intra_payload_rejects_what_jax_rejects(jax_intra_blob):
    blob = jax_intra_blob
    parsers = (tct.IntraPayload.from_bytes, jct.IntraPayload.from_bytes)

    def same_verdict(data):
        verdicts = []
        for parse in parsers:
            try:
                parse(data)
                verdicts.append("ok")
            except ValueError:
                verdicts.append("ValueError")
        assert verdicts[0] == verdicts[1], verdicts

    for n in sorted(set(range(0, len(blob), 7)) | {len(blob) - 1}):
        with pytest.raises(ValueError):
            tct.IntraPayload.from_bytes(blob[:n])
    rng = np.random.default_rng(12)
    for pos in sorted(set(range(64)) | {int(p) for p in rng.integers(0, len(blob), 96)}):
        for flip in (0xFF, 0x80, 0x01):
            mutated = bytearray(blob)
            mutated[pos] ^= flip
            same_verdict(bytes(mutated))
    for off in range(8, min(len(blob) - 4, 160), 4):
        for val in (0xFFFFFFFF, 0x7FFFFFFF, 1 << 24):
            mutated = bytearray(blob)
            struct.pack_into("<I", mutated, off, val)
            same_verdict(bytes(mutated))
    for bad in (b"", b"\x00" * 64, b"PNG\x89 not ours, definitely not an IVC1 container...."):
        with pytest.raises(ValueError):
            tct.IntraPayload.from_bytes(bad)
    with pytest.raises(ValueError, match="kind"):
        tct.IntraPayload.from_bytes(blob[:6] + bytes([2]) + blob[7:])


def test_foreign_kind_is_rejected():
    y = np.random.default_rng(2).integers(0, 256, (3, 32, 32)).astype(np.float32)
    gop = TFused(1.0, device="cpu").train(y[:2]).encode_to_container(y)
    with pytest.raises(ValueError, match="intra/plane"):
        tct.IntraPayload.from_bytes(gop)


def test_payload_assembly_matches_jax():
    rng = np.random.default_rng(13)
    G, wpg = 3, 24
    words = rng.integers(0, 2**32, (G, wpg), dtype=np.uint64).astype(np.uint32)
    gbits = rng.integers(1, wpg * 32, G).astype(np.int32)
    offs = (np.arange(G)[:, None] * wpg * 32 + np.sort(rng.integers(0, 700, (G, 16)))).reshape(-1)
    counts = rng.integers(1, 97, G * 16)
    cb = np.full(70, 7, dtype=np.uint8)
    args = (tct.KIND_INTRA, (20, 30, 3), 0.5, 4000, 999, words, gbits, offs, counts)
    t = tct.grouped_payload_from_device(*args, codebook=tct.Codebook(-6, cb),
                                        words_per_group=wpg, group_size=16)
    j = jct.grouped_payload_from_device(*args, codebook=jct.Codebook(-6, cb),
                                        words_per_group=wpg, group_size=16)
    assert t.to_bytes() == j.to_bytes()
    for gb in (gbits, np.zeros(3, np.int32), np.array([1600 * 32])):
        assert tct.packer_wmax(gb, 1600) == jct.packer_wmax(gb, 1600)
    far = offs.copy()
    far[5] = 1 << 17  # an in-group offset past the u16 sidecar
    with pytest.raises(ValueError, match="u16"):
        tct.grouped_payload_from_device(*args[:7], far, counts, codebook=tct.Codebook(-6, cb),
                                        words_per_group=wpg, group_size=16)


# ------------------------------------------------------------ the codec


def _case_image(case):
    if case.startswith("odd"):
        h, w = (45, 61) if case == "odd45" else (41, 57)
        return (np.random.default_rng(42).random((h, w, 3)) * 255).astype(np.uint8), True
    img = fixtures.image("lena_small")
    if case == "gray":
        return img.astype(np.float32).mean(axis=-1), False
    return img, True


@pytest.mark.parametrize("case,q", [("rgb", 0.15), ("rgb", 0.5), ("rgb", 2.0), ("gray", 1.0),
                                    ("odd45", 0.5), ("odd41", 0.5)])
def test_codec_matches_jax(case, q):
    img, rgb = _case_image(case)
    j, t = JIntra(q), TIntra(q, device="cpu")
    j.train_huffman_from_image(img, is_source_rgb=rgb)
    t.train_huffman_from_image(img, is_source_rgb=rgb)
    assert t.bounds == j.bounds
    assert_exact(t.huffman.code.lengths, j.huffman.code.lengths, "code lengths")
    assert_exact(t.image2symbols(img, rgb), j.image2symbols(img, rgb), "symbols")

    t_words, t_bpp = t.intra_encode(img, return_bpp=True, is_source_rgb=rgb)
    j_words, j_bpp = j.intra_encode(img, return_bpp=True, is_source_rgb=rgb)
    assert t_words.dtype == np.uint32
    assert_exact(t_words, j_words, "flat stream words")
    assert t_bpp == j_bpp and t.num_symbols == j.num_symbols

    t_blob = t.encode_to_container(img, is_source_rgb=rgb)
    j_blob = j.encode_to_container(img, is_source_rgb=rgb)
    assert t_blob == j_blob
    t_rec = TIntra.decode_from_container(j_blob, device="cpu")
    j_rec = np.asarray(JIntra.decode_from_container(t_blob))
    assert isinstance(t_rec, torch.Tensor) and tuple(t_rec.shape) == np.shape(img)
    assert_close(t_rec, j_rec, RECON_TOL, "each side decodes the other's bytes")

    t_ed, _, t_bits = t.encode_decode(img, is_source_rgb=rgb)
    j_ed, _, j_bits = j.encode_decode(img, is_source_rgb=rgb)
    assert t_bits == j_bits
    assert_close(t_ed, j_ed, RECON_TOL, "encode_decode")
    assert_close(t_rec, t_ed, RECON_TOL, "container decode vs encode_decode")
    assert_close(t.intra_decode(t_words, np.shape(img)), t_ed, RECON_TOL, "serial decode")


@pytest.mark.parametrize("case", ["rgb", "gray"])
def test_adaptive_codec_matches_jax(case):
    img, rgb = _case_image(case)
    encoder = TAdaptive(0.5, device="cpu")
    t_packed, t_bits = encoder.intra_encode(img, is_source_rgb=rgb)
    j_packed, j_bits = JAdaptive(0.5).intra_encode(img, is_source_rgb=rgb)
    assert t_bits == j_bits
    assert t_packed[0] == j_packed[0] and t_packed[1] == j_packed[1] and t_packed[3] == j_packed[3]
    assert_exact(t_packed[2], j_packed[2], "words")
    rec = TAdaptive(0.5, device="cpu").intra_decode(j_packed, np.shape(img))
    assert_close(rec, JAdaptive(0.5).intra_decode(t_packed, np.shape(img)), RECON_TOL,
                 "cross decode")
    fresh = TAdaptive(0.5, device="cpu")
    assert_close(fresh.intra_decode(t_packed, np.shape(img)), rec, RECON_TOL, "own decode")
    assert fresh.bounds == encoder.bounds


def test_golden_rd_point(lena_small, lena):
    """Train on lena_small, code lena at q=0.15: the canonical ch3 point."""
    codec = TIntra(quantization_scale=0.15, device="cpu")
    codec.train_huffman_from_image(lena_small)
    recon, _, bits, bpp = codec.encode_decode(lena, return_bpp=True)
    psnr = float(t_psnr(lena, recon))
    assert abs(psnr - 38.93) < 0.3
    assert abs(bpp - 4.518) < 0.15
    j = JIntra(0.15)
    j.train_huffman_from_image(lena_small)
    j_recon, _, j_bits = j.encode_decode(lena)
    assert bits == j_bits
    assert psnr == pytest.approx(float(j_psnr(lena, j_recon)), abs=1e-3)


def test_from_reference_state_reproduces_jax_bytes(lena_small):
    j = JIntra(0.5)
    j.train_huffman_from_image(lena_small)
    t = TIntra.from_reference_state(tintra.reference_state(j), device="cpu")
    assert t.bounds == j.bounds
    other = np.ascontiguousarray(fixtures.image("sail")[:64, :96])
    assert t.encode_to_container(other) == j.encode_to_container(other)
    t_words, _ = t.intra_encode(other)
    assert_exact(t_words, j.intra_encode(other)[0], "words")


def test_device_decode_matches_jax_and_serial(lena_small):
    img = np.ascontiguousarray(lena_small[:64, :128])
    j = JIntra(0.5)
    j.train_huffman_from_image(img)
    t = TIntra.from_reference_state(tintra.reference_state(j), device="cpu")
    x, shape = t._prepare(img, True)
    words, total, offs, valid, _ = t._encode_device(x)
    rec, ok = t.decode_device(words, offs, valid, shape)
    assert bool(ok)
    jx, _ = j._prepare(img, True)
    j_words, _, j_offs, j_valid, _ = j._encode_device(jx)
    j_rec, j_ok = j.decode_device(j_words, j_offs, j_valid, shape)
    assert bool(j_ok)
    assert_close(rec, j_rec, RECON_TOL, "device decode")
    t.num_symbols = int(valid.sum())
    serial = t.intra_decode(words[: (int(total) + 31) // 32].numpy().astype(np.uint32), shape)
    assert_close(rec, serial, 1e-3, "device vs serial decode")
    full, _, _ = t.encode_decode(img, verify_entropy=True)
    direct, _, _ = t.encode_decode(img)
    assert_close(full, direct, 1e-3, "verify_entropy")


def test_codec_errors(lena_small):
    img = lena_small[:32, :32]
    with pytest.raises(RuntimeError, match="Train"):
        TIntra(1.0, device="cpu").encode_to_container(img)
    with pytest.raises(RuntimeError, match="symbol count"):
        TIntra(1.0, device="cpu").intra_decode(np.zeros(4, np.uint32), img.shape)
    codec = TIntra(1.0, device="cpu")
    codec.train_huffman_from_image(img)
    symbols = codec.image2symbols(img)
    with pytest.raises(ValueError, match="zero-run decode failed"):
        codec.symbols2image(symbols[:-1], img.shape)
    blob = bytearray(codec.encode_to_container(img))
    payload = tct.IntraPayload.from_bytes(bytes(blob))
    counts_at = len(blob) - 4 * int(payload.group_word_counts.sum()) - payload.block_counts.size
    blob[counts_at] = 1  # block 0 now ends before its EOB
    with pytest.raises(ValueError, match="container decode failed"):
        TIntra.decode_from_container(bytes(blob), device="cpu")
