"""The benchmark's frozen roofline copy gives the bounds the port's
``utils/timing.py`` gives today, on fixed inputs."""

import numpy as np
import pytest

from codec_bench import roofline, trace
from ivclab_tpu_torch.utils import timing


def test_motion_search_bound():
    for args in [(1088, 1088, 1920, 4), (1088, 1088, 1920, 0), (1088, 1088, 1920, 16),
                 (288, 272, 1920, 4)]:
        assert roofline.motion_search_bound(*args) == timing.motion_search_bound(*args)
    ms, kind = roofline.motion_search_bound(1088, 1088, 1920, 4)
    assert kind == "operations" and ms == pytest.approx(0.00758, abs=5e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_bounds(seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 900, 4096)
    for LW, cap in [(16, 64), (32, 128), (4, 32)]:
        assert roofline.decode_walk_bound(bits, LW, cap) == timing.decode_walk_bound(bits, LW, cap)
    offs = np.cumsum(rng.integers(0, 600, 4096))
    n_words = int(offs[-1] // 32) + 40
    assert (roofline.canon_walk_bound(offs, bits, n_words, 48)
            == timing.canon_walk_bound(offs, bits, n_words, 48))


def test_kernel_base_name():
    for name in ["void (anonymous namespace)::me_kernel<4>(float const*, float const*, int*)",
                 "_ZN12_GLOBAL__N_111walk_kernelILi64EEEvPKlPKiS4_", "canon_walk_kernel",
                 "void at::native::vectorized_elementwise_kernel<4, float>(int, float)"]:
        assert trace.kernel_base_name(name) == timing.kernel_base_name(name)
