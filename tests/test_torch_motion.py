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

import ivclab_tpu_torch.ops.motion as tmotion
from ivclab_tpu_torch.runtime import cuda_build


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
        kwargs["search_range"] = 8
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


def test_kernel_build_is_content_addressed():
    path = cuda_build.library_path("motion_search")
    assert path.parent == cuda_build.CSRC / "_build"
    assert path.name.startswith("motion_search_") and path.suffix == ".so"
    assert path == cuda_build.library_path("motion_search")
