"""Parity of the port's adaptive-video and P-frame containers with the JAX package.

``pack_symbols_grouped_sized``, ``GroupedSection.from_packer_sliced``, the
``AdaptiveVideoPayload`` and ``PFramePayload`` wire formats (bytes written
by either side parse on the other and re-serialize to the same bytes), and
the hostile-bytes cases of ``tests/test_container_fuzz.py`` for both kinds:
every failure is a ``ValueError``, with the JAX parser's verdict.
"""

import struct

import numpy as np
import pytest

from torch_parity import assert_exact, to_torch

import ivclab_tpu.ops.transform as jtr
import ivclab_tpu.runtime.container as jct
from ivclab_tpu.entropy.codebook import build_canonical_code as j_build_code
from ivclab_tpu.models.videocodec import VideoCodec as JVideo

import ivclab_tpu_torch.ops.transform as ttr
import ivclab_tpu_torch.runtime.container as tct

_H = _W = 32  # 16 blocks per frame: one pack group


@pytest.fixture(scope="module")
def jax_blobs():
    """One JAX-written blob of each kind (tiny content, built once)."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, size=(3, _H, _W)).astype(np.float32)
    adaptive = JVideo(quantization_scale=1.0, codebook_policy="per-frame").encode_to_container(frames)
    facade = JVideo(quantization_scale=1.0)
    facade.encode_decode(np.repeat(frames[0][..., None], 3, axis=-1), frame_num=0)
    _, pframe, _ = facade.encode_decode(np.repeat(frames[1][..., None], 3, axis=-1), frame_num=1)
    return {"adaptive": adaptive, "pframe": pframe}


PARSERS = {
    "adaptive": (tct.AdaptiveVideoPayload.from_bytes, jct.AdaptiveVideoPayload.from_bytes),
    "pframe": (tct.PFramePayload.from_bytes, jct.PFramePayload.from_bytes),
}


def _verdict(parse, data) -> str:
    try:
        parse(data)
        return "ok"
    except ValueError:
        return "ValueError"


def _same_verdict(kind, data):
    verdicts = [_verdict(parse, data) for parse in PARSERS[kind]]
    assert verdicts[0] == verdicts[1], verdicts


# ------------------------------------------------------------ packers


def _random_frame(rng, n_blocks, cap, lo, hi, max_count):
    buf = rng.integers(lo, hi, (n_blocks, cap)).astype(np.int32)
    valid = rng.integers(1, max_count + 1, n_blocks).astype(np.int32)
    valid[3] = 0  # an empty block
    pmf = rng.random(hi - lo) + 0.05
    return buf, valid, j_build_code(pmf / pmf.sum(), lower_bound=lo)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("buckets", ["fit", "overflow"])
def test_pack_symbols_grouped_sized_matches_jax(fuse, buckets):
    rng = np.random.default_rng(5 + fuse)
    buf, valid, code = _random_frame(rng, 48, 32, -40, 60, 24)
    assert code.max_len <= jtr.FUSED_TABLE_MAX_LEN
    wpg, bw = (128, 32) if buckets == "fit" else (8, 2)
    j = jtr.pack_symbols_grouped_sized(buf, valid, code.codes, code.lengths, np.int32(code.lower_bound),
                                       wpg, bw, fuse_table=fuse)
    t = ttr.pack_symbols_grouped_sized(to_torch(buf), to_torch(valid), to_torch(code.codes),
                                       to_torch(code.lengths), code.lower_bound, wpg, bw,
                                       fuse_table=fuse)
    for name, got, want in zip(("words", "group bits", "offsets", "total"), t, j):
        assert_exact(got, np.asarray(want), name)
    assert (ttr.ADAPTIVE_WPG, ttr.ADAPTIVE_BW, ttr.FUSED_TABLE_MAX_LEN) == (
        jtr.ADAPTIVE_WPG, jtr.ADAPTIVE_BW, jtr.FUSED_TABLE_MAX_LEN)
    if buckets == "fit":  # where the buckets hold, the full-stride pack's stream
        full = ttr.pack_symbols_grouped(to_torch(buf), to_torch(valid), to_torch(code.codes),
                                        to_torch(code.lengths), code.lower_bound)
        assert_exact(t[0], full[0][:, :wpg], "words vs full stride")
        assert_exact(t[1], full[1], "group bits vs full stride")


def test_from_packer_sliced_matches_jax():
    rng = np.random.default_rng(13)
    G, stride, wmax = 3, 128, 24
    words = rng.integers(0, 2**32, (G, wmax), dtype=np.uint64).astype(np.uint32)
    gbits = rng.integers(1, wmax * 32, G).astype(np.int32)
    offs = (np.arange(G)[:, None] * stride * 32 + np.sort(rng.integers(0, 700, (G, 16)))).reshape(-1)
    counts = rng.integers(0, 97, G * 16)
    t = tct.GroupedSection.from_packer_sliced(to_torch(words), to_torch(gbits), to_torch(offs),
                                              to_torch(counts), 16, stride, wmax)
    j = jct.GroupedSection.from_packer_sliced(words, gbits, offs, counts, 16, stride, wmax)
    assert t.to_bytes() == j.to_bytes()
    for field in ("words", "group_word_counts", "block_offsets", "block_counts"):
        assert_exact(getattr(t, field), getattr(j, field), field)
    assert t.words_per_group == wmax and t.words.dtype == np.uint32
    with pytest.raises(ValueError, match="u16"):
        tct.GroupedSection.from_packer_sliced(words, gbits, offs + (1 << 16), counts, 16, stride,
                                              wmax)
    # the unsliced form is the same assembly
    full = tct.GroupedSection.from_device(words, gbits, offs - np.repeat(
        np.arange(G) * (stride - wmax) * 32, 16), counts, 16, wmax)
    assert full.to_bytes() == t.to_bytes()


# ------------------------------------------------------------ payloads


def test_kinds_match_jax():
    assert (tct.KIND_VIDEO_ADAPTIVE, tct.KIND_PFRAME) == (jct.KIND_VIDEO_ADAPTIVE, jct.KIND_PFRAME)


@pytest.mark.parametrize("kind", ["adaptive", "pframe"])
def test_payload_round_trips_jax_bytes(jax_blobs, kind):
    blob = jax_blobs[kind]
    t, j = PARSERS[kind][0](blob), PARSERS[kind][1](blob)
    assert t.to_bytes() == blob
    assert t.container_bytes == len(blob)
    assert (t.quantization_scale, t.eob, t.search_range, t.shape, t.payload_bits) == (
        j.quantization_scale, j.eob, j.search_range, j.shape, j.payload_bits)
    sections = ([t.mv] + [s for _, s in t.frames] if kind == "adaptive" else [t.mv, t.residual])
    for s in sections:
        for got, want in zip(s.device_views(device="cpu"), s.device_views(device="cpu")):
            assert got.device.type == "cpu"
    if kind == "adaptive":
        assert t.policy == j.policy == 0 and len(t.frames) == 3
        assert_exact(t.frame_bits, j.frame_bits, "frame bits")
        # the same fields written by each side give the same bytes
        rebuilt = tct.AdaptiveVideoPayload(
            t.quantization_scale, t.eob, t.search_range, 1, t.shape, t.payload_bits, t.frame_bits,
            t.mv_codebook, t.mv, t.frames)
        jrebuilt = jct.AdaptiveVideoPayload(
            j.quantization_scale, j.eob, j.search_range, 1, j.shape, j.payload_bits, j.frame_bits,
            j.mv_codebook, j.mv, j.frames)
    else:
        rebuilt = tct.PFramePayload(0.5, t.eob, 7, t.shape, 99, t.mv_codebook, t.mv,
                                    t.residual_codebook, t.residual)
        jrebuilt = jct.PFramePayload(0.5, j.eob, 7, j.shape, 99, j.mv_codebook, j.mv,
                                     j.residual_codebook, j.residual)
    assert rebuilt.to_bytes() == jrebuilt.to_bytes()
    assert PARSERS[kind][0](rebuilt.to_bytes()).to_bytes() == rebuilt.to_bytes()


# ------------------------------------------------------------ hostile bytes


@pytest.mark.parametrize("kind", ["adaptive", "pframe"])
def test_valid_blob_parses(jax_blobs, kind):
    for parse in PARSERS[kind]:
        parse(jax_blobs[kind])


@pytest.mark.parametrize("kind", ["adaptive", "pframe"])
def test_truncations_raise_value_error(jax_blobs, kind):
    blob = jax_blobs[kind]
    for n in sorted(set(range(0, len(blob), 7)) | {len(blob) - 1}):
        with pytest.raises(ValueError):
            PARSERS[kind][0](blob[:n])


@pytest.mark.parametrize("kind", ["adaptive", "pframe"])
def test_single_byte_flips_get_the_jax_verdict(jax_blobs, kind):
    blob = jax_blobs[kind]
    rng = np.random.default_rng(len(kind))
    positions = set(range(min(64, len(blob)))) | {int(p) for p in rng.integers(0, len(blob), 128)}
    for pos in sorted(positions):
        for flip in (0xFF, 0x80, 0x01):
            mutated = bytearray(blob)
            mutated[pos] ^= flip
            _same_verdict(kind, bytes(mutated))


@pytest.mark.parametrize("kind", ["adaptive", "pframe"])
def test_oversized_u32_counts_get_the_jax_verdict(jax_blobs, kind):
    blob = jax_blobs[kind]
    for off in range(8, min(len(blob) - 4, 160), 4):
        for val in (0xFFFFFFFF, 0x7FFFFFFF, 1 << 24):
            mutated = bytearray(blob)
            struct.pack_into("<I", mutated, off, val)
            _same_verdict(kind, bytes(mutated))


def test_foreign_and_empty_buffers(jax_blobs):
    for parse in (tct.AdaptiveVideoPayload.from_bytes, tct.PFramePayload.from_bytes):
        for bad in (b"", b"\x00" * 64, b"PNG\x89 not ours, definitely not an IVC1 container...."):
            with pytest.raises(ValueError):
                parse(bad)
    with pytest.raises(ValueError, match="adaptive"):
        tct.AdaptiveVideoPayload.from_bytes(jax_blobs["pframe"])
    with pytest.raises(ValueError, match="P-frame"):
        tct.PFramePayload.from_bytes(jax_blobs["adaptive"])
