"""Parity of the port's codebooks and IVC1 container with the JAX package.

The same histogram must build the same canonical hot/escape code, and the
container must serialize byte for byte as the JAX package does, parse the
JAX package's bytes, and reject truncated or oversized blobs with
``ValueError``.
"""

import struct

import numpy as np
import pytest
import torch

from torch_parity import assert_exact, luma

import ivclab_tpu.entropy.codebook as jcb
import ivclab_tpu.runtime.container as jct
from ivclab_tpu.models.fastvideo import FusedVideoCodec as JaxCodec
from ivclab_tpu.utils import fixtures

import ivclab_tpu_torch.entropy.codebook as tcb
import ivclab_tpu_torch.runtime.container as tct


def _histograms():
    rng = np.random.default_rng(21)
    lap = np.floor(5e4 * np.exp(-np.abs(np.arange(640) - 320) / 7.0)) + rng.integers(0, 2, 640)
    return {
        "laplacian": lap,
        "random": rng.integers(0, 1000, 300).astype(np.float64),
        "sparse": np.where(rng.random(500) < 0.1, rng.integers(1, 50, 500), 0).astype(float),
        "skewed": 2.0 ** -np.arange(60) * 1e18,
        "single": np.array([0.0, 0.0, 7.0, 0.0]),
        "uniform": np.ones(81),
    }


def _assert_same_canonical(t, j):
    assert (t.lower_bound, t.min_len, t.max_len, t.n) == (j.lower_bound, j.min_len, j.max_len, j.n)
    for field in ("lengths", "codes", "lj_next_minus1", "first_code", "group_offset",
                  "sorted_syms"):
        assert_exact(getattr(t, field), getattr(j, field), field)


@pytest.mark.parametrize("name", list(_histograms()))
def test_hot_code_from_same_histogram(name):
    hist = _histograms()[name]
    K = 81 if name == "uniform" else 127
    j = jcb.build_hot_code(hist, lower_bound=-320, K=K)
    t = tcb.build_hot_code(hist, lower_bound=-320, K=K)
    assert (t.lower_bound, t.alphabet_n, t.raw_bits, t.esc_rank, t.K) == (
        j.lower_bound, j.alphabet_n, j.raw_bits, j.esc_rank, j.K)
    assert_exact(t.hot_values, j.hot_values, "hot_values")
    assert_exact(t.alpha_of_rank, j.alpha_of_rank, "alpha_of_rank")
    assert_exact(t.fused_table(), j.fused_table(), "fused table")
    assert t.mean_len_bound() == j.mean_len_bound()
    _assert_same_canonical(t.code, j.code)
    rebuilt = tcb.hot_code_from_parts(j.lower_bound, j.alphabet_n, j.hot_values, j.code.lengths)
    assert_exact(rebuilt.alpha_of_rank, j.alpha_of_rank, "from parts")


@pytest.mark.parametrize("max_len", [8, 12, 26])
def test_length_limited_canonical_code(max_len):
    pmf = 2.0 ** -np.arange(40)
    pmf /= pmf.sum()
    lengths = tcb.huffman_code_lengths(pmf)
    assert_exact(lengths, jcb.huffman_code_lengths(pmf), "huffman lengths")
    assert_exact(tcb.limit_code_lengths(lengths, max_len),
                 jcb.limit_code_lengths(lengths, max_len), "limited lengths")
    _assert_same_canonical(tcb.build_canonical_code(pmf, -5, max_len),
                           jcb.build_canonical_code(pmf, -5, max_len))


def test_codebook_errors_match():
    with pytest.raises(ValueError):
        tcb.huffman_code_lengths(np.array([1.0, 0.0, 2.0]))
    with pytest.raises(ValueError):
        tcb.canonical_from_lengths(np.array([0, 1]))
    with pytest.raises(ValueError):
        tcb.hot_code_from_parts(0, 16, np.array([1, 2]), np.array([1, 2]))


@pytest.fixture(scope="module")
def jax_blob():
    y = luma(fixtures.video("bench", 3, (64, 128)))
    codec = JaxCodec(1.0).train(y[:2])
    return codec.encode_to_container(y)


def test_payload_round_trip_is_byte_identical(jax_blob):
    t = tct.VideoPayload.from_bytes(jax_blob)
    assert t.to_bytes() == jax_blob
    j = jct.VideoPayload.from_bytes(jax_blob)
    assert t.max_block_words() == j.max_block_words()
    assert t.container_bytes == len(jax_blob)
    for section in ("residual", "mv"):
        ts, js = getattr(t, section), getattr(j, section)
        for got, want in zip(ts.device_views("cpu"), js.device_views()):
            assert isinstance(got, torch.Tensor)
            assert_exact(got, np.asarray(want), f"{section} device view")
    assert jct.VideoPayload.from_bytes(t.to_bytes()).to_bytes() == jax_blob


def test_grouped_section_from_device_matches():
    rng = np.random.default_rng(8)
    words = rng.integers(0, 2**32, (4, 64), dtype=np.uint64).astype(np.uint32)
    gbits = rng.integers(0, 64 * 32, 4).astype(np.int32)
    offs = (np.arange(4)[:, None] * 64 * 32 + np.sort(rng.integers(0, 2000, (4, 16)))).reshape(-1)
    counts = rng.integers(1, 64, 64)
    j = jct.GroupedSection.from_device(words, gbits, offs, counts, 16, 64)
    t = tct.GroupedSection.from_device(torch.from_numpy(words.astype(np.int64)),
                                       torch.from_numpy(gbits), torch.from_numpy(offs),
                                       torch.from_numpy(counts), 16, 64)
    assert t.to_bytes() == j.to_bytes()


@pytest.mark.parametrize("cut", [3, 20, 60, 200, -500, -1])
def test_truncated_payload_rejected(jax_blob, cut):
    with pytest.raises(ValueError):
        tct.VideoPayload.from_bytes(jax_blob[:cut])


def _patch(blob, offset, fmt, value):
    b = bytearray(blob)
    struct.pack_into(fmt, b, offset, value)
    return bytes(b)


def _residual_section_offset(blob):
    r = tct._Reader(memoryview(blob))
    r.unpack("<4sHBBfiIIIQ")
    r.unpack("<B")
    (T,) = struct.unpack_from("<I", blob, 4 + 2 + 1 + 1 + 4 + 4)
    r.array("<u8", T, "frame bits")
    tct.HotCodebook.from_buffer(r)
    tct.HotCodebook.from_buffer(r)
    return r.off


@pytest.mark.parametrize("case", ["magic", "kind", "shape", "wpg", "alloc", "sidecar", "gwc"])
def test_hostile_payload_rejected(jax_blob, case):
    sec = _residual_section_offset(jax_blob)
    if case == "magic":
        bad = b"XVC1" + jax_blob[4:]
    elif case == "kind":
        bad = _patch(jax_blob, 6, "<B", 3)
    elif case == "shape":
        bad = _patch(jax_blob, 16, "<I", 0)
    elif case == "wpg":
        bad = _patch(jax_blob, sec + 2, "<I", 4096)
    elif case == "alloc":  # huge group count: the allocation cap must refuse it
        bad = _patch(_patch(jax_blob, sec + 6, "<I", 1 << 24), sec + 10, "<Q", 16 << 24)
    elif case == "sidecar":
        bad = _patch(jax_blob, sec + 10, "<Q", 17)
    else:  # a group word count beyond the stride
        bad = _patch(jax_blob, sec + 18, "<I", 1 << 20)
    with pytest.raises(ValueError):
        tct.VideoPayload.from_bytes(bad)
    with pytest.raises(ValueError):
        jct.VideoPayload.from_bytes(bad)
