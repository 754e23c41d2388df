"""Tests of the port that need a CUDA card; each skips where there is none.

This file imports neither JAX nor ``ivclab_tpu``, so it also runs on the
GPU machine, which has no JAX (tests/conftest.py imports it, hence
``--noconftest``):

    python3 -m pytest tests/test_torch_cuda.py --noconftest -q

It holds the kernels' two entry points (whole frames and halo-extended row
bands) against their plain PyTorch versions on the card (``me_kernel`` at
search ranges 1..15; ``wide_kernel`` at 0, 16, 17, 24, 32 and 255, on
float, tie-heavy, +inf-SSD and no-winner inputs, each launch counted on
its own kernel's counter; the codecs at sr 0 and 16 give the CPU port's
bytes), the GOP codec's
CUDA pack against its CPU pack, the sharded codec on the card against the
fused pack, and the intra codec's CUDA container bytes against its CPU
bytes; the adaptive video codec's bytes, launches and decodes on the card
against its CPU bytes (at search ranges 4 and 8), and the sharded adaptive
encoder against the single-device one; the ch1/ch2 library's filters,
wavefront and ``PredictiveCodec`` against the CPU port (equal bits; the
FFT within its tolerance); and it checks that the C++ entropy engine builds
there. The CPU parity with the JAX package is in the other
tests/test_torch_*.py files.
"""

import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    assert_exact,
    cuda_device,
    luma,
    reference_state,
)

import ivclab_tpu_torch.ops.motion as tmotion
from ivclab_tpu_torch import (
    FusedVideoCodec,
    HuffmanCoder,
    IntraCodec,
    PredictiveCodec,
    VideoCodec,
    three_pixels_predictor,
)
from ivclab_tpu_torch import parallel as tpar
from ivclab_tpu_torch.models import intracodec as tintra
from ivclab_tpu_torch.models.predictive import COEFFS_CBCR, COEFFS_Y
from ivclab_tpu_torch.ops.predictive import predict_from_neighbors, reconstruct_from_residual
from ivclab_tpu_torch.ops.resample import decimate, decimate_iir, lowpass_filter
from ivclab_tpu_torch.runtime import native
from ivclab_tpu_torch.utils import fixtures


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,sr", [(1088, 1920, 4), (288, 352, 4), (40, 56, 4), (64, 384, 2),
                                    (64, 128, 7), (64, 128, 1)])
def test_kernel_matches_plain_on_integer_and_flat_frames(cuda_device, H, W, sr):
    """Integer-valued frames make every SSD exact: kernel == plain, ties included."""
    rng = np.random.default_rng(H + W + sr)
    ref = rng.integers(0, 256, (H, W)).astype(np.float32)
    cur = (np.roll(ref, (3, -2), (0, 1)) + rng.integers(-3, 4, (H, W))).astype(np.float32)
    R = torch.from_numpy(ref).to(cuda_device)
    C = torch.from_numpy(cur).to(cuda_device)
    before = tmotion.LAUNCHES
    got = tmotion.motion_search(R, C, sr)
    torch.cuda.synchronize()
    assert tmotion.LAUNCHES == before + 1
    assert_exact(got, tmotion.motion_search_reference(R, C, sr), "kernel vs plain")
    flat = torch.full((H, W), 7.0, device=cuda_device)
    assert_exact(tmotion.motion_search_cuda(flat, flat, sr),
                 tmotion.motion_search_reference(flat, flat, sr), "flat")


@pytest.mark.cuda
def test_kernel_float_mismatches_are_near_ties(cuda_device):
    y = luma(fixtures.video("foreman", 2, (288, 352)))
    R = torch.from_numpy(y[0]).to(cuda_device)
    C = torch.from_numpy(y[1]).to(cuda_device)
    a = tmotion.motion_search_cuda(R, C, 4).cpu().numpy()
    b = tmotion.motion_search_reference(R, C, 4).cpu().numpy()
    ref, cur = y[0].astype(np.float64), y[1].astype(np.float64)
    for by, bx in np.argwhere(a != b):
        blk = cur[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8]
        ssd = []
        for idx in (a[by, bx], b[by, bx]):
            y0, x0 = by * 8 + idx // 9 - 4, bx * 8 + idx % 9 - 4
            ssd.append(((blk - ref[y0:y0 + 8, x0:x0 + 8]) ** 2).sum())
        assert abs(ssd[0] - ssd[1]) <= 1e-5 * max(ssd[0], ssd[1], 1.0)


def _bands_of(H):
    """Band height for splitting an H-row frame: halves where they are whole
    8-row blocks, else single block rows."""
    return H // 2 if (H // 2) % 8 == 0 else 8


SEARCH_RANGES = [*range(1, 8), 8, 11, 15]


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(288, 352), (40, 56), (64, 384)])
@pytest.mark.parametrize("sr", SEARCH_RANGES)
def test_kernel_equals_kernel_order_plain_on_float_frames(cuda_device, H, W, sr):
    """The kernel repeats the kernel-order plain version's arithmetic, so
    both entry points equal it bit for bit on float frames, every band too."""
    rng = np.random.default_rng(1000 * sr + H)
    ref = (rng.random((H, W)) * 255).astype(np.float32)
    cur = (np.roll(ref, (2, -3), (0, 1)) + rng.normal(0, 0.3, (H, W))).astype(np.float32)
    R = torch.from_numpy(ref).to(cuda_device)
    C = torch.from_numpy(cur).to(cuda_device)
    assert_exact(tmotion.motion_search_cuda(R, C, sr),
                 tmotion.motion_search_kernel_order(R, C, sr), "whole frame")
    band_h = _bands_of(H)
    for i in range(H // band_h):
        ext, band = _band(R, C, i, band_h, sr)
        assert_exact(tmotion.motion_search_tile_cuda(ext, band, i * band_h, H, sr),
                     tmotion.motion_search_tile_kernel_order(ext, band, i * band_h, H, sr),
                     f"band {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["flat", "periodic"])
@pytest.mark.parametrize("sr", SEARCH_RANGES)
def test_kernel_on_tie_heavy_frames(cuda_device, pattern, sr):
    """Many candidates tie: the first valid one in scan order must win, and
    zero-filled out-of-frame candidates (SSD 0 on a flat zero frame) never."""
    H, W = 64, 128
    if pattern == "flat":
        ref = np.zeros((H, W), np.float32)
        cur = np.zeros((H, W), np.float32)
    else:  # 2-pixel periodic: every even displacement ties exactly
        yy, xx = np.indices((H, W))
        ref = (40.0 * (2 * (yy % 2) + xx % 2) + 10.0).astype(np.float32)
        cur = np.roll(ref, (1, 0), (0, 1))
    R = torch.from_numpy(ref).to(cuda_device)
    C = torch.from_numpy(cur).to(cuda_device)
    got = tmotion.motion_search_cuda(R, C, sr)
    assert_exact(got, tmotion.motion_search_kernel_order(R, C, sr), "vs kernel order")
    assert_exact(got, tmotion.motion_search_reference(R, C, sr), "vs plain reference")
    for i in range(4):
        ext, band = _band(R, C, i, 16, sr)
        a = tmotion.motion_search_tile_cuda(ext, band, i * 16, H, sr)
        assert_exact(a, tmotion.motion_search_tile_kernel_order(ext, band, i * 16, H, sr),
                     f"band {i}")
        assert_exact(a, got[i * 2:(i + 1) * 2], f"band {i} vs whole frame")


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [4, 7, 8, 15])
def test_first_and_last_band_equal_kernel_order_plain(cuda_device, sr):
    """The bench fixture at 1088x1920 in 4 bands: row0 = 0, whose halo rows
    above lie outside the frame, and the last band, whose halo rows below do."""
    H, W, band_h = 1088, 1920, 272
    y = luma(fixtures.video("bench", 2, (H, W)))
    R = torch.from_numpy(y[0]).to(cuda_device)
    C = torch.from_numpy(y[1]).to(cuda_device)
    whole = tmotion.motion_search_cuda(R, C, sr)
    for i in (0, H // band_h - 1):
        ext, band = _band(R, C, i, band_h, sr)
        got = tmotion.motion_search_tile_cuda(ext, band, i * band_h, H, sr)
        assert_exact(got, tmotion.motion_search_tile_kernel_order(ext, band, i * band_h, H, sr),
                     f"band {i}")
        assert_exact(got, whole[i * band_h // 8:(i + 1) * band_h // 8], f"band {i} vs whole")


def _launch_counts():
    return (tmotion.LAUNCHES, tmotion.TILE_LAUNCHES, tmotion.WIDE_LAUNCHES,
            tmotion.WIDE_TILE_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [-1, 23170])
def test_kernel_refuses_search_ranges_no_kernel_takes(cuda_device, sr):
    """Below 0, or (2 sr + 1)**2 candidates past int32 (sr = 23170)."""
    x = torch.zeros((64, 64), device=cuda_device)
    ext = torch.zeros((64 + 2 * max(sr, 0), 64), device=cuda_device)
    before = _launch_counts()
    with pytest.raises(ValueError, match="int32"):
        tmotion.motion_search_cuda(x, x, sr)
    with pytest.raises(ValueError, match="int32"):
        tmotion.motion_search_tile_cuda(ext, x, 0, 64, sr)
    assert _launch_counts() == before


WIDE_RANGES = [0, 16, 17, 24, 32]


def _wide_check(R, C, sr, band_h, label):
    """Both entry points at range sr against the kernel-order plain version,
    bit for bit, every launch on the wide kernel's counters."""
    H = R.shape[0]
    before = _launch_counts()
    got = tmotion.motion_search(R, C, sr)
    torch.cuda.synchronize()
    assert _launch_counts() == (before[0], before[1], before[2] + 1, before[3]), label
    assert_exact(got, tmotion.motion_search_kernel_order(R, C, sr), f"{label} whole frame")
    for i in range(H // band_h):
        ext, band = _band(R, C, i, band_h, sr)
        n = tmotion.WIDE_TILE_LAUNCHES
        a = tmotion.motion_search_tile(ext, band, i * band_h, H, sr)
        torch.cuda.synchronize()
        assert tmotion.WIDE_TILE_LAUNCHES == n + 1
        assert_exact(a, tmotion.motion_search_tile_kernel_order(ext, band, i * band_h, H, sr),
                     f"{label} band {i}")
        assert_exact(a, got[i * band_h // 8:(i + 1) * band_h // 8], f"{label} band {i} vs whole")
    assert (tmotion.LAUNCHES, tmotion.TILE_LAUNCHES) == before[:2]
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(40, 56), (64, 384), (288, 352)])
@pytest.mark.parametrize("sr", WIDE_RANGES)
def test_wide_kernel_equals_kernel_order_plain_on_float_frames(cuda_device, H, W, sr):
    rng = np.random.default_rng(7000 + 10 * sr + H)
    ref = (rng.random((H, W)) * 255).astype(np.float32)
    cur = (np.roll(ref, (5, -7), (0, 1)) + rng.normal(0, 0.3, (H, W))).astype(np.float32)
    _wide_check(torch.from_numpy(ref).to(cuda_device), torch.from_numpy(cur).to(cuda_device),
                sr, _bands_of(H), f"float {H}x{W} sr={sr}")


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["flat", "periodic", "inf-ssd", "all-inf", "all-nan"])
@pytest.mark.parametrize("sr", WIDE_RANGES)
def test_wide_kernel_on_ties_and_non_finite_ssds(cuda_device, pattern, sr):
    """Ties (flat zero frames, where zero-filled out-of-frame candidates must
    not win; a 2-pixel-periodic pattern); SSDs that overflow to +inf at some
    candidates (never a winner); and blocks with no winner at all (+inf or
    NaN at every candidate: index 0)."""
    H, W = 64, 128
    rng = np.random.default_rng(800 + sr)
    if pattern == "flat":
        ref = cur = np.zeros((H, W), np.float32)
    elif pattern == "periodic":
        yy, xx = np.indices((H, W))
        ref = (40.0 * (2 * (yy % 2) + xx % 2) + 10.0).astype(np.float32)
        cur = np.roll(ref, (1, 0), (0, 1))
    elif pattern == "inf-ssd":
        ref = (rng.random((H, W)) * 255).astype(np.float32)
        ref[rng.random((H, W)) < 0.02] = 3e38  # (3e38 - c)^2 overflows
        cur = (np.roll(ref, (2, 3), (0, 1)) + rng.normal(0, 0.3, (H, W))).astype(np.float32)
        cur = np.minimum(cur, 255).astype(np.float32)
    elif pattern == "all-inf":
        ref = np.full((H, W), 3e38, np.float32)
        cur = np.full((H, W), -3e38, np.float32)
    else:
        ref = (rng.random((H, W)) * 255).astype(np.float32)
        cur = np.full((H, W), np.nan, np.float32)
    got = _wide_check(torch.from_numpy(ref).to(cuda_device),
                      torch.from_numpy(np.ascontiguousarray(cur)).to(cuda_device), sr, 16,
                      f"{pattern} sr={sr}")
    if pattern in ("all-inf", "all-nan"):
        assert int(got.abs().sum()) == 0


@pytest.mark.cuda
def test_wide_kernel_at_search_range_255(cuda_device):
    """The largest range the containers store (a uint8): 261,121 candidates
    a block, on a small frame."""
    rng = np.random.default_rng(255)
    ref = (rng.random((64, 64)) * 255).astype(np.float32)
    cur = (np.roll(ref, (9, -20), (0, 1)) + rng.normal(0, 0.3, (64, 64))).astype(np.float32)
    _wide_check(torch.from_numpy(ref).to(cuda_device), torch.from_numpy(cur).to(cuda_device),
                255, 32, "float 64x64 sr=255")


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [1, 8, 15])
def test_search_ranges_1_to_15_stay_on_me_kernel(cuda_device, sr):
    x = torch.from_numpy((np.random.default_rng(sr).random((64, 128)) * 255)
                         .astype(np.float32)).to(cuda_device)
    before = _launch_counts()
    tmotion.motion_search(x, x.roll(1, 1).contiguous(), sr)
    ext, band = _band(x, x, 1, 16, sr)
    tmotion.motion_search_tile(ext, band, 16, 64, sr)
    torch.cuda.synchronize()
    assert _launch_counts() == (before[0] + 1, before[1] + 1, before[2], before[3])


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [0, 16])
@pytest.mark.parametrize("codec", ["VideoCodec", "FusedVideoCodec"])
def test_codecs_at_wide_search_ranges_match_cpu_bytes(cuda_device, codec, sr):
    """3 frames at 256x480 through the wide kernel: the CPU port's bytes,
    one wide launch per P-frame in the container encode."""
    y = luma(fixtures.video("bench", 3, (256, 480)))
    before = tmotion.WIDE_LAUNCHES
    if codec == "VideoCodec":
        blob = VideoCodec(1.0, search_range=sr, device=cuda_device).encode_to_container(y)
        want = VideoCodec(1.0, search_range=sr, device="cpu").encode_to_container(y)
        torch.cuda.synchronize()
        assert tmotion.WIDE_LAUNCHES - before == 2
    else:
        g = FusedVideoCodec(1.0, sr, device=cuda_device).train(y[:2])
        c = FusedVideoCodec(1.0, sr, device="cpu").train(y[:2])
        mid = tmotion.WIDE_LAUNCHES
        blob = g.encode_to_container(y)
        torch.cuda.synchronize()
        assert mid - before == 1 and tmotion.WIDE_LAUNCHES - mid == 2
        want = c.encode_to_container(y)
    assert blob == want


@pytest.mark.cuda
def test_kernel_refuses_a_misaligned_plane(cuda_device):
    flat = torch.zeros(16 * 32 + 1, device=cuda_device)
    x = torch.zeros((16, 32), device=cuda_device)
    before = tmotion.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        tmotion.motion_search_cuda(flat[1:].view(16, 32), x, 4)
    assert tmotion.LAUNCHES == before


@pytest.mark.cuda
def test_gop_on_the_card_matches_cpu_bytes(cuda_device):
    seq = luma(fixtures.video("bench", 4, (128, 256)))
    g = FusedVideoCodec(1.0, device=cuda_device).train(seq[:2])
    qsyms, mvs, _, _ = g.encode_gop(seq)
    c = FusedVideoCodec.from_reference_state(reference_state(g), device="cpu")
    pg, pc = g.pack_gop(qsyms), c.pack_gop(qsyms.cpu())
    assert g.container_from_packed(pg, mvs, seq.shape) == c.container_from_packed(
        pc, mvs.cpu(), seq.shape)
    rec, ok = g.decode_gop(pg.words, pg.offsets, pg.counts, mvs, 128, 256,
                           pg.block_words, pg.cap)
    assert bool(ok) and rec.is_cuda
    rc, okc = c.decode_gop(pc.words, pc.offsets, pc.counts, mvs.cpu(), 128, 256,
                           pc.block_words, pc.cap)
    assert bool(okc) and float((rec.cpu() - rc).abs().max()) < 1e-2


def _band(ref, cur, i, band_h, sr):
    """Band i of [H, W] frames: the reference band with its halo rows cut from
    the frame (zeros outside it) and the current band."""
    padded = torch.nn.functional.pad(ref, (0, 0, sr, sr))
    return (padded[i * band_h:(i + 1) * band_h + 2 * sr].contiguous(),
            cur[i * band_h:(i + 1) * band_h].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [1, 4, 7])
def test_band_halo_rows_outside_the_frame_do_not_matter(cuda_device, sr):
    """The kernel copies a band's whole halo-extended reference; rows that
    fall outside the frame (above the first band, below the last) reach only
    masked candidates, so NaN there gives the indices that zeros give."""
    H, W, band_h = 64, 128, 16
    rng = np.random.default_rng(50 + sr)
    ref = (rng.random((H, W)) * 255).astype(np.float32)
    cur = (np.roll(ref, (1, 2), (0, 1)) + rng.normal(0, 0.5, (H, W))).astype(np.float32)
    R = torch.from_numpy(ref).to(cuda_device)
    C = torch.from_numpy(cur).to(cuda_device)
    for i, outside in ((0, slice(0, sr)), (H // band_h - 1, slice(band_h + sr, band_h + 2 * sr))):
        ext, band = _band(R, C, i, band_h, sr)
        want = tmotion.motion_search_tile_cuda(ext, band, i * band_h, H, sr)
        ext[outside] = float("nan")
        got = tmotion.motion_search_tile_cuda(ext, band, i * band_h, H, sr)
        assert_exact(got, want, f"band {i}")
        assert_exact(got, tmotion.motion_search_tile_kernel_order(ext, band, i * band_h, H, sr),
                     f"band {i} vs kernel order")


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,n_bands", [(1088, 1920, 4), (288, 352, 2), (64, 128, 4)])
@pytest.mark.parametrize("sr", [2, 4, 7])
def test_band_kernel_matches_plain_at_every_band(cuda_device, H, W, n_bands, sr):
    """Integer-valued frames: each band equals the plain band search, and the
    bands together equal the whole-frame kernel."""
    rng = np.random.default_rng(H + W + sr)
    ref = rng.integers(0, 256, (H, W)).astype(np.float32)
    cur = (np.roll(ref, (3, -2), (0, 1)) + rng.integers(-3, 4, (H, W))).astype(np.float32)
    R = torch.from_numpy(ref).to(cuda_device)
    C = torch.from_numpy(cur).to(cuda_device)
    band_h = H // n_bands
    got = []
    for i in range(n_bands):
        ext, band = _band(R, C, i, band_h, sr)
        before = tmotion.TILE_LAUNCHES
        a = tmotion.motion_search_tile(ext, band, i * band_h, H, sr)
        torch.cuda.synchronize()
        assert tmotion.TILE_LAUNCHES == before + 1
        assert_exact(a, tmotion.motion_search_tile_reference(ext, band, i * band_h, H, sr),
                     f"band {i}")
        got.append(a)
    assert_exact(torch.cat(got), tmotion.motion_search_cuda(R, C, sr), "bands vs whole frame")


@pytest.mark.cuda
@pytest.mark.parametrize("row0,ext_rows,total_h", [(4, 24, 64), (56, 24, 64), (0, 26, 64),
                                                   (-8, 24, 64)])
def test_band_kernel_refuses_bad_windows(cuda_device, row0, ext_rows, total_h):
    ext = torch.zeros((ext_rows, 32), device=cuda_device)
    band = torch.zeros((16, 32), device=cuda_device)
    before = tmotion.TILE_LAUNCHES
    with pytest.raises(RuntimeError):
        tmotion.motion_search_tile_cuda(ext, band, row0, total_h, 4)
    assert tmotion.TILE_LAUNCHES == before


@pytest.mark.cuda
def test_sharded_codec_on_the_card_matches_the_fused_pack(cuda_device):
    seq = luma(fixtures.video("bench", 4, (128, 256)))
    codec = FusedVideoCodec(1.0, device=cuda_device).train(seq[:2])
    fused = []
    for g in range(2):
        qsyms, mvs, _, recons = codec.encode_gop(seq[g * 2:(g + 1) * 2])
        fused.append((codec.pack_gop(qsyms), mvs, recons))
    cap, bw, gw = codec._buckets
    mesh = tpar.make_mesh(2, 2, device=cuda_device)
    before = tmotion.TILE_LAUNCHES
    out = tpar.build_sharded_video_codec(mesh, codec, 2, 64, 256, cap, gw, bw)(
        tpar.shard_frames(seq, mesh))
    torch.cuda.synchronize()
    assert tmotion.TILE_LAUNCHES - before == 2 * 1 * 2  # GOPs x P-frames x bands
    blobs = tpar.assemble_video_payloads(codec, out, 2)
    for g, (p, mvs, recons) in enumerate(fused):
        sl = slice(g * 2, (g + 1) * 2)
        for field in ("words", "offsets", "counts", "group_bits", "totals"):
            assert_exact(getattr(out, field)[sl], getattr(p, field), field)
        assert_exact(out.mvs[sl], mvs, "mvs")
        assert torch.equal(out.recons[sl], recons)
        assert blobs[g] == codec.container_from_packed(p, mvs, (2, 128, 256))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 256), (41, 57)])
def test_intra_container_on_the_card_matches_cpu_bytes(cuda_device, shape):
    if shape == (256, 256):
        img = fixtures.image("lena_small")
    else:
        img = (np.random.default_rng(42).random((*shape, 3)) * 255).astype(np.uint8)
    g = IntraCodec(0.5, device=cuda_device)
    g.train_huffman_from_image(img)
    c = IntraCodec.from_reference_state(tintra.reference_state(g), device="cpu")
    blob = g.encode_to_container(img)
    assert blob == c.encode_to_container(img)
    rec = IntraCodec.decode_from_container(blob, device=cuda_device)
    assert rec.is_cuda and tuple(rec.shape) == img.shape
    ref, _, _ = g.encode_decode(img)
    assert float((rec - ref).abs().max()) < 1e-2
    rec_cpu = IntraCodec.decode_from_container(blob, device="cpu")
    assert float((rec.cpu() - rec_cpu).abs().max()) < 1e-2


@pytest.mark.cuda
def test_native_engine_builds_on_the_gpu_machine(cuda_device):
    assert native.available(), native.unavailable_reason()
    coder = HuffmanCoder(lower_bound=-2).train(np.array([0.5, 0.25, 0.125, 0.125]))
    msg = np.random.default_rng(1).integers(-2, 2, 1000)
    words, bits = coder.encode(msg)
    assert bits == float(coder.code.lengths[msg + 2].sum())
    assert np.array_equal(coder.decode(words, msg.size), msg)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["per-frame", "adaptive"])
def test_adaptive_container_on_the_card_matches_cpu_bytes(cuda_device, policy):
    """VideoCodec.encode_to_container at 256x480: one whole-frame launch per
    P-frame, the CPU port's bytes, and both devices' decodes within 1e-2."""
    y = luma(fixtures.video("bench", 4, (256, 480)))
    g = VideoCodec(1.0, codebook_policy=policy, device=cuda_device)
    before = tmotion.LAUNCHES
    blob = g.encode_to_container(y)
    torch.cuda.synchronize()
    assert tmotion.LAUNCHES - before == 3
    assert blob == VideoCodec(1.0, codebook_policy=policy, device="cpu").encode_to_container(y)
    rec, oks = VideoCodec.decode_from_container(blob, return_device=True, device=cuda_device)
    assert rec.is_cuda and bool(oks.all())
    assert float((rec[-1] - g.decoder_recon).abs().max()) < 1e-2
    rec_cpu = VideoCodec.decode_from_container(blob, device="cpu")
    assert float(np.abs(rec.cpu().numpy() - rec_cpu).max()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["per-frame", "adaptive", "first-p-frame"])
def test_facade_launches_one_search_per_p_frame(cuda_device, policy):
    rgb = fixtures.video("bench", 3, (256, 480))
    codec = VideoCodec(1.0, codebook_policy=policy, device=cuda_device)
    counts, prev = [], None
    for t in range(3):
        before = tmotion.LAUNCHES
        out, blob, _ = codec.encode_decode(rgb[t], frame_num=t)
        torch.cuda.synchronize()
        counts.append(tmotion.LAUNCHES - before)
        assert out.is_cuda and out.dtype == torch.uint8
        dec = VideoCodec.decode_frame_payload(blob, prev, device=cuda_device)
        assert float((dec - codec.decoder_recon).abs().max()) < 1e-2
        prev = dec
    assert counts == [0, 1, 1]


@pytest.mark.cuda
def test_sharded_adaptive_encoder_on_the_card_matches_single_device(cuda_device):
    y = luma(fixtures.video("bench", 4, (256, 480)))
    mesh = tpar.make_mesh(2, 4, device=cuda_device)
    before = tmotion.TILE_LAUNCHES
    blobs = tpar.ShardedAdaptiveEncoder(mesh, 2, 64, 480).encode(y)
    torch.cuda.synchronize()
    assert tmotion.TILE_LAUNCHES - before == 2 * 1 * 4  # GOPs x P-frames x bands
    for g in range(2):
        single = VideoCodec(1.0, device=cuda_device).encode_to_container(y[2 * g:2 * g + 2])
        assert blobs[g] == single


@pytest.mark.cuda
def test_video_codec_at_search_range_8_on_the_card_matches_cpu_bytes(cuda_device):
    """A codec with search_range >= 8 runs its motion search on the card."""
    y = luma(fixtures.video("bench", 3, (256, 480)))
    g = VideoCodec(1.0, search_range=8, device=cuda_device)
    before = tmotion.LAUNCHES
    blob = g.encode_to_container(y)
    torch.cuda.synchronize()
    assert tmotion.LAUNCHES - before == 2
    assert blob == VideoCodec(1.0, search_range=8, device="cpu").encode_to_container(y)


def _plane(seed, shape):
    return torch.from_numpy((np.random.default_rng(seed).random(shape) * 255).astype(np.float32))


_SIGNAL_OPS = {
    "decimate axis 0": lambda x: decimate(x, 2, axis=0),
    "decimate axis 1": lambda x: decimate(x, 2, axis=1),
    "lowpass_filter": lambda x: lowpass_filter(x, np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]])),
    "decimate_iir axis 0": lambda x: decimate_iir(x, 2, axis=0),
    "decimate_iir axis 1": lambda x: decimate_iir(x, 2, axis=1),
    "wavefront q=1": lambda x: torch.cat(predict_from_neighbors(x, COEFFS_Y, 1.0, True)),
    "wavefront q=3": lambda x: torch.cat(predict_from_neighbors(x, COEFFS_Y, 3.0, True)),
    "inverse wavefront q=3": lambda x: reconstruct_from_residual(
        torch.round(x / 16), x[0], x[:, 0], COEFFS_CBCR, 3.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(_SIGNAL_OPS))
def test_signal_ops_equal_on_cuda_and_cpu(cuda_device, op):
    """Fixed-order elementwise IEEE arithmetic: the same bits on both."""
    x = _plane(60, (200, 168))
    got = _SIGNAL_OPS[op](x.to(cuda_device))
    assert got.is_cuda
    assert torch.equal(got.cpu(), _SIGNAL_OPS[op](x)), op


@pytest.mark.cuda
@pytest.mark.parametrize("subsample", [False, True])
@pytest.mark.parametrize("q", [1.0, 4.0])
def test_predictive_codec_bits_equal_on_cuda_and_cpu(cuda_device, subsample, q):
    img = fixtures.image("lena_small")
    rec, bits = PredictiveCodec(q, subsample, device=cuda_device).encode_decode(img)
    rec_c, bits_c = PredictiveCodec(q, subsample, device="cpu").encode_decode(img)
    assert rec.is_cuda and bits == bits_c
    # the subsampled chroma comes back through the FFT (cuFFT vs pocketfft)
    assert int((rec.cpu().int() - rec_c.int()).abs().max()) <= (1 if subsample else 0)
    y, c = three_pixels_predictor(img, subsample, device=cuda_device)
    yc, cc = three_pixels_predictor(img, subsample, device="cpu")
    assert torch.equal(y.cpu(), yc) and torch.equal(c.cpu(), cc)
