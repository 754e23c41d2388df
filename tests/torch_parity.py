"""Helpers for the PyTorch port's parity tests against the JAX package.

The same numpy inputs, made from a seeded ``np.random.default_rng``, go to
a JAX function and to its twin in ``ivclab_tpu_torch``. Integers and bytes
must be equal exactly; each float comparison states its tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# tier-1 runs several pytest-xdist workers on one host
torch.set_num_threads(1)

# Float tolerances, with their reasons.
# DCT/IDCT: one float32 [N,64]x[64,64] product; the two libraries may sum
# the 64 terms in another order (a few ulp of values up to ~2e3).
DCT_TOL = 1e-4
# Reconstructions: bench.py's decoder-vs-encoder bound.
RECON_TOL = 1e-2


def to_torch(a) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor; unsigned 32-bit words become int64."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True))


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_exact(port, ref, what: str = ""):
    """Integer arrays equal in shape and value (dtype-independent)."""
    p = to_numpy(port)
    r = to_numpy(ref)
    assert p.shape == r.shape, f"{what}: shape {p.shape} != {r.shape}"
    pi, ri = p.astype(np.int64), r.astype(np.int64)
    bad = np.argwhere(pi != ri)
    assert bad.size == 0, (
        f"{what}: {len(bad)} of {p.size} differ; first at {tuple(bad[0])}: "
        f"port {pi[tuple(bad[0])]} vs JAX {ri[tuple(bad[0])]}"
    )


def assert_close(port, ref, tol: float, what: str = ""):
    p = to_numpy(port).astype(np.float64)
    r = to_numpy(ref).astype(np.float64)
    assert p.shape == r.shape, f"{what}: shape {p.shape} != {r.shape}"
    err = float(np.abs(p - r).max()) if p.size else 0.0
    assert err <= tol, f"{what}: max abs {err} > {tol}"


def reference_state(codec) -> dict:
    """A JAX ``FusedVideoCodec``'s trained state as plain numbers and arrays
    (the input of ``ivclab_tpu_torch.FusedVideoCodec.from_reference_state``)."""
    def parts(code):
        return (int(code.lower_bound), int(code.alphabet_n),
                np.asarray(code.hot_values), np.asarray(code.code.lengths))

    buckets = getattr(codec, "_buckets", None)
    return {
        "quantization_scale": float(codec.q),
        "search_range": int(codec.sr),
        "residual_code": parts(codec.residual_code),
        "mv_code": parts(codec.mv_code),
        "buckets": None if buckets is None else tuple(int(b) for b in buckets),
    }


def luma(frames) -> np.ndarray:
    """bench.py's luma: the float32 mean of the RGB channels."""
    return np.ascontiguousarray(np.asarray(frames).astype(np.float32).mean(axis=-1))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)
