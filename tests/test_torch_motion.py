"""Parity of the port's motion search and compensation with the JAX package.

The plain PyTorch search must equal both the JAX candidate scan and the
Pallas kernel (run in interpret mode, as tests/test_motion_pallas.py runs
it), including widths the TPU kernel refused. The CUDA kernel itself runs
only on a GPU: its tests are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_exact, luma, to_torch

from ivclab_tpu.ops.motion import (
    motion_compensate as j_motion_compensate,
    motion_compensate_dense as j_motion_compensate_dense,
    motion_search as j_motion_search,
)
from ivclab_tpu.ops.motion_pallas import motion_search_pallas
from ivclab_tpu.parallel.halo import motion_search_tile as j_motion_search_tile

import ivclab_tpu_torch.ops.motion as tmotion
from ivclab_tpu_torch.runtime import cuda_build
from ivclab_tpu_torch.utils.timing import motion_search_bound


def _frames(rng, H, W, dy, dx, noise=0.5):
    ref = (rng.random((H, W)) * 255).astype(np.float32)
    cur = np.roll(ref, (dy, dx), axis=(0, 1)).astype(np.float32)
    cur += rng.normal(0, noise, cur.shape).astype(np.float32)
    return ref, cur


@pytest.mark.parametrize("H,W,sr", [(64, 128, 4), (64, 256, 4), (40, 56, 4), (32, 96, 2)])
def test_search_matches_jax_and_pallas(H, W, sr):
    rng = np.random.default_rng(H * W + sr)
    ref, cur = _frames(rng, H, W, dy=3, dx=-2)
    port = tmotion.motion_search_reference(to_torch(ref), to_torch(cur), sr)
    assert_exact(port, j_motion_search(ref, cur, sr), "vs JAX scan")
    assert_exact(port, motion_search_pallas(ref, cur, sr, interpret=True), "vs Pallas")


def test_search_on_video_fixture(foreman):
    """The foreman 96x352 crop: real motion, a width no 128 divides."""
    y = luma(foreman[:2, :96, :352])
    port = tmotion.motion_search(to_torch(y[0]), to_torch(y[1]), 4)
    assert_exact(port, j_motion_search(y[0], y[1], 4), "vs JAX scan")
    assert_exact(port, motion_search_pallas(y[0], y[1], 4, interpret=True), "vs Pallas")


@pytest.mark.parametrize("level", [(128.0, 128.0), (100.0, 120.0)])
def test_search_on_flat_frames(level):
    """Every candidate ties: the first valid one in scan order must win."""
    ref = np.full((48, 64), level[0], np.float32)
    cur = np.full((48, 64), level[1], np.float32)
    port = tmotion.motion_search_reference(to_torch(ref), to_torch(cur), 4)
    assert_exact(port, j_motion_search(ref, cur, 4), "flat")


def test_cpu_dispatch_uses_the_plain_version():
    rng = np.random.default_rng(4)
    ref, cur = _frames(rng, 32, 64, 1, 2)
    before = tmotion.LAUNCHES
    got = tmotion.motion_search(to_torch(ref), to_torch(cur), 4)
    assert tmotion.LAUNCHES == before
    assert_exact(got, tmotion.motion_search_reference(to_torch(ref), to_torch(cur), 4))


@pytest.mark.parametrize("bad", ["cpu", "float64", "shape", "sr"])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((16, 24))
    kwargs = {"search_range": 4}
    if bad == "float64":
        x = x.double()
    elif bad == "shape":
        x = torch.zeros((12, 24))
    elif bad == "sr":
        kwargs["search_range"] = 16  # the kernel is built for 1..15
    with pytest.raises(ValueError):
        tmotion.motion_search_cuda(x, x, **kwargs)


def test_compensate_matches_dense_on_encoder_fields():
    """Gather MC == the JAX select-based MC for fields the encoder emits."""
    rng = np.random.default_rng(9)
    ref, cur = _frames(rng, 64, 96, dy=-2, dx=3)
    mv = np.asarray(j_motion_search(ref, cur, 4))
    port = tmotion.motion_compensate(to_torch(ref), to_torch(mv), 4)
    assert_exact(port.numpy().view(np.int32), np.asarray(
        j_motion_compensate_dense(ref, mv, 4)).view(np.int32), "vs dense MC (bits)")


def test_compensate_matches_gather_on_any_field():
    """Arbitrary fields: out-of-frame displacements and out-of-range indices."""
    rng = np.random.default_rng(10)
    ref = (rng.random((40, 56)) * 255).astype(np.float32)
    mv = rng.integers(-5, 90, (5, 7)).astype(np.int32)
    port = tmotion.motion_compensate(to_torch(ref), to_torch(mv), 4)
    assert_exact(port.numpy().view(np.int32),
                 np.asarray(j_motion_compensate(ref, mv, 4)).view(np.int32), "vs gather MC")


def _integer_pair(rng, H, W):
    ref = rng.integers(0, 256, (H, W)).astype(np.float32)
    cur = (np.roll(ref, (3, -2), (0, 1)) + rng.integers(-3, 4, (H, W))).astype(np.float32)
    return ref, cur


# the wide kernel's ranges (sr 0 and sr >= 16) on the CPU tests' sizes
WIDE_RANGES = [0, 16, 17, 32]


@pytest.mark.parametrize("H,W,sr", [(64, 128, sr) for sr in range(1, 8)]
                         + [(40, 56, 4), (40, 56, 7), (32, 96, 2)]
                         + [(H, W, sr) for sr in WIDE_RANGES for H, W in ((40, 56), (64, 128))])
def test_kernel_order_plain_matches_reference_and_jax(H, W, sr):
    """Integer-valued and flat frames make every SSD exact, so the
    kernel-order sum equals the plain reference and JAX's scan, ties
    included; at the wide kernel's ranges too (at sr 32 most of a 40x56
    frame's candidates lie outside it)."""
    rng = np.random.default_rng(H * W + sr)
    cases = {"integer": _integer_pair(rng, H, W),
             "flat": (np.full((H, W), 100.0, np.float32), np.full((H, W), 120.0, np.float32))}
    for name, (ref, cur) in cases.items():
        got = tmotion.motion_search_kernel_order(to_torch(ref), to_torch(cur), sr)
        assert got.dtype == torch.int32 and tuple(got.shape) == (H // 8, W // 8)
        assert_exact(got, tmotion.motion_search_reference(to_torch(ref), to_torch(cur), sr),
                     f"{name} vs plain reference")
        assert_exact(got, j_motion_search(ref, cur, sr), f"{name} vs JAX scan")


@pytest.mark.parametrize("sr", [1, 4, 7, *WIDE_RANGES])
def test_kernel_order_band_matches_band_reference(sr):
    """Every band of a 64x128 frame in 4 bands, halo rows cut from the frame;
    at the wide kernel's ranges also every band of a 40x56 frame in 5, on
    integer and flat frames, each band against JAX's band search too."""
    sizes = [(64, 128, 16)] + ([(40, 56, 8)] if sr in WIDE_RANGES else [])
    for H, W, band_h in sizes:
        cases = {"integer": _integer_pair(np.random.default_rng(sr), H, W)}
        if sr in WIDE_RANGES:
            cases["flat"] = (np.full((H, W), 100.0, np.float32), np.full((H, W), 120.0, np.float32))
        for name, (ref, cur) in cases.items():
            padded = np.pad(ref, ((sr, sr), (0, 0)))
            bands = []
            for i in range(H // band_h):
                ext_np = padded[i * band_h:(i + 1) * band_h + 2 * sr]
                cur_np = cur[i * band_h:(i + 1) * band_h]
                ext, band = to_torch(ext_np), to_torch(cur_np)
                got = tmotion.motion_search_tile_kernel_order(ext, band, i * band_h, H, sr)
                what = f"{H}x{W} {name} band {i}"
                assert_exact(got, tmotion.motion_search_tile_reference(
                    ext, band, i * band_h, H, sr), what)
                if sr in WIDE_RANGES:
                    assert_exact(got, j_motion_search_tile(ext_np, cur_np, i * band_h, H, sr),
                                 f"{what} vs JAX")
                bands.append(got)
            assert_exact(torch.cat(bands), tmotion.motion_search_kernel_order(
                to_torch(ref), to_torch(cur), sr), f"{H}x{W} {name} bands vs whole frame")


@pytest.mark.parametrize("H,W", [(40, 56), (64, 128)])
def test_search_range_0_gives_index_0_on_any_input(H, W):
    """At sr 0 the one candidate is (0, 0), index 0, whatever its SSD: on
    float frames, on frames with NaN and with +-inf pixels, and on bands,
    in both plain versions and JAX's scan."""
    rng = np.random.default_rng(H + W)
    ref = (rng.random((H, W)) * 255).astype(np.float32)
    nan_cur = ref.copy()
    nan_cur[rng.random((H, W)) < 0.3] = np.nan
    inf_ref = np.where(rng.random((H, W)) < 0.3, np.inf, ref).astype(np.float32)
    cases = {"float": (ref, np.roll(ref, (1, 2), (0, 1))), "nan": (ref, nan_cur),
             "inf": (inf_ref, -inf_ref), "all-nan": (np.full_like(ref, np.nan), ref)}
    zeros = np.zeros((H // 8, W // 8), np.int32)
    for name, (r, c) in cases.items():
        R, C = to_torch(r), to_torch(c)
        for fn in (tmotion.motion_search_reference, tmotion.motion_search_kernel_order):
            assert_exact(fn(R, C, 0), zeros, f"{name} {fn.__name__}")
        assert_exact(j_motion_search(r, c, 0), zeros, f"{name} JAX")
        for i in range(H // 8):
            rows = slice(i * 8, i * 8 + 8)
            for fn in (tmotion.motion_search_tile_reference,
                       tmotion.motion_search_tile_kernel_order):
                assert_exact(fn(R[rows], C[rows], i * 8, H, 0), zeros[i:i + 1],
                             f"{name} band {i} {fn.__name__}")


@pytest.mark.parametrize("sr", [1, 4, 7])
def test_band_halo_rows_outside_the_frame_do_not_matter(sr):
    """A band's halo rows above row 0 or below the frame reach only masked
    candidates: NaN there gives the indices zeros give, in both plain
    versions (the kernel copies those rows too)."""
    H, W, band_h = 64, 128, 16
    ref, cur = _frames(np.random.default_rng(70 + sr), H, W, dy=1, dx=2)
    padded = np.pad(ref, ((sr, sr), (0, 0)))
    for i, outside in ((0, slice(0, sr)), (H // band_h - 1, slice(band_h + sr, band_h + 2 * sr))):
        ext = padded[i * band_h:(i + 1) * band_h + 2 * sr].copy()
        band = to_torch(cur[i * band_h:(i + 1) * band_h])
        want = tmotion.motion_search_tile_kernel_order(to_torch(ext), band, i * band_h, H, sr)
        ext[outside] = np.nan
        for fn in (tmotion.motion_search_tile_kernel_order, tmotion.motion_search_tile_reference):
            assert_exact(fn(to_torch(ext), band, i * band_h, H, sr), want, f"band {i}")


@pytest.mark.parametrize("sr", [2, 4, 7])
def test_kernel_order_plain_differs_from_reference_only_at_near_ties(sr):
    """On float frames the two summation orders may flip only a near-tie:
    the two chosen candidates' float64 SSDs within 1e-5 relative."""
    H, W = 64, 128
    rng = np.random.default_rng(100 + sr)
    ref, cur = _frames(rng, H, W, dy=1, dx=-2, noise=0.01)
    cur[:, :40] = np.round(cur[:, :40] * 4) / 4  # coarse values: many close SSDs
    a = tmotion.motion_search_kernel_order(to_torch(ref), to_torch(cur), sr).numpy()
    b = tmotion.motion_search_reference(to_torch(ref), to_torch(cur), sr).numpy()
    total = 2 * sr + 1
    ref64, cur64 = ref.astype(np.float64), cur.astype(np.float64)
    for by, bx in np.argwhere(a != b):
        blk = cur64[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8]
        ssd = []
        for idx in (a[by, bx], b[by, bx]):
            y0, x0 = by * 8 + idx // total - sr, bx * 8 + idx % total - sr
            ssd.append(((blk - ref64[y0:y0 + 8, x0:x0 + 8]) ** 2).sum())
        assert abs(ssd[0] - ssd[1]) <= 1e-5 * max(ssd[0], ssd[1], 1.0)


def test_kernel_build_is_content_addressed(tmp_path):
    path = cuda_build.library_path("motion_search")
    assert path.parent == cuda_build.CSRC / "_build"
    assert path.name.startswith("motion_search_") and path.suffix == ".so"
    assert path == cuda_build.library_path("motion_search")
    # another revision of the source builds beside it, under its own hash
    other = tmp_path / "motion_search.cu"
    other.write_text(cuda_build.CSRC.joinpath("motion_search.cu").read_text() + "\n")
    built = cuda_build._hashed(other, cuda_build.NVCC_FLAGS, tmp_path)
    built.touch()  # as if compiled: build_file reuses it without nvcc
    assert cuda_build.build_file(other, tmp_path) == (built, "")
    assert built.name != path.name and built.name.startswith("motion_search_")


@pytest.mark.parametrize("rows,ref_rows,sr,want_us", [(1088, 1088, 4, 7.576), (272, 280, 4, 1.894),
                                                      (272, 286, 7, 5.261)])
def test_search_bound_counts_every_candidate(rows, ref_rows, sr, want_us):
    """The least time on the H100 is the FP32 operations over the peak:
    blocks x (2sr+1)^2 x 64 x 3 at 67 TFLOP/s."""
    ms, by = motion_search_bound(ref_rows, rows, 1920, sr)
    assert by == "operations"
    assert ms * 1e3 == pytest.approx(want_us, abs=1e-3)
