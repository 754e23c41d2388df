"""Tests of the port that need a CUDA card; each skips where there is none.

This file imports neither JAX nor ``ivclab_tpu``, so it also runs on the
GPU machine, which has no JAX (tests/conftest.py imports it, hence
``--noconftest``):

    python3 -m pytest tests/test_torch_cuda.py --noconftest -q

It holds the kernel against its plain PyTorch version on the card and the
codec's CUDA pack against its CPU pack; the CPU parity with the JAX package
is in the other tests/test_torch_*.py files.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_exact, cuda_device, luma, reference_state  # noqa: F401

import ivclab_tpu_torch.ops.motion as tmotion
from ivclab_tpu_torch import FusedVideoCodec
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


@pytest.mark.cuda
def test_gop_on_the_card_matches_cpu_bytes(cuda_device):
    seq = luma(fixtures.video("bench", 4, (128, 256)))
    g = FusedVideoCodec(1.0, device=cuda_device).train(seq[:2])
    qsyms, mvs, _, _ = g.encode_gop(seq)
    c = FusedVideoCodec.from_reference_state(reference_state(g))
    pg, pc = g.pack_gop(qsyms), c.pack_gop(qsyms.cpu())
    assert g.container_from_packed(pg, mvs, seq.shape) == c.container_from_packed(
        pc, mvs.cpu(), seq.shape)
    rec, ok = g.decode_gop(pg.words, pg.offsets, pg.counts, mvs, 128, 256,
                           pg.block_words, pg.cap)
    assert bool(ok) and rec.is_cuda
    rc, okc = c.decode_gop(pc.words, pc.offsets, pc.counts, mvs.cpu(), 128, 256,
                           pc.block_words, pc.cap)
    assert bool(okc) and float((rec.cpu() - rc).abs().max()) < 1e-2
