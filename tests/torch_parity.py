"""Helpers for the PyTorch port's parity tests against the JAX package.

The same numpy inputs, made from a seeded ``np.random.default_rng``, go to
a JAX function and to its twin in ``ivclab_tpu_torch``. Integers and bytes
must be equal exactly; each float comparison states its tolerance.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

# reads a JAX or port VideoCodec, mid-sequence too, for VideoCodec.from_reference_state
from ivclab_tpu_torch.models.videocodec import reference_state as video_reference_state  # noqa: F401

# tier-1 runs several pytest-xdist workers on one host
torch.set_num_threads(1)

_NATIVE = Path(__file__).resolve().parents[1] / "ivclab_tpu" / "runtime" / "native"


def prebuild_reference_native(src: Path = _NATIVE / "entropy.cpp",
                              build_dir: Path = _NATIVE / "_build") -> Path | None:
    """Build the JAX package's C++ entropy engine where its loader looks for it.

    ``ivclab_tpu/runtime/native.py`` compiles ``entropy.cpp`` on first use
    into ``_build/libivclab_native_<sha256(src)[:16]>.so`` through one
    shared temporary name, so pytest-xdist workers that reach it together
    on an empty ``_build/`` clobber each other's half-written library and
    fall back to "engine unavailable". Every worker imports this module
    while it collects, before any test runs: building here, one process at
    a time under an exclusive lock, leaves the library in place for the
    loader. Imports nothing of ``ivclab_tpu`` (which imports JAX). Does
    nothing when the library exists, the source is absent or there is no
    ``g++``; returns the library's path, or None when there is none.
    """
    if not src.is_file():
        return None
    out = build_dir / f"libivclab_native_{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    if out.exists():
        return out
    if shutil.which("g++") is None:
        return None
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "prebuild.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():  # another process may have built it meanwhile
            tmp = build_dir / f"{out.name}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(src)]
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=300)
                os.replace(tmp, out)
            except (subprocess.SubprocessError, OSError):
                tmp.unlink(missing_ok=True)
                return None
    return out


prebuild_reference_native()

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


# The positional arguments of ops/bitpack.py::decode_blocks_hot, by name.
WALK_ARGS = ("local", "counts", "lj", "first_code", "group_offset", "alpha_of_rank", "min_len",
             "esc_rank", "max_syms", "raw_bits", "max_len")


def captured_walks(monkeypatch, device="cpu") -> dict:
    """The arguments of the two walks that decoding a 128x256 8-frame GOP's
    IVC1 container runs: the MV streams first, then the residual streams."""
    from ivclab_tpu_torch import FusedVideoCodec
    from ivclab_tpu_torch.models import fastvideo as tfv
    from ivclab_tpu_torch.utils import fixtures

    y = luma(fixtures.video("bench", 8, (128, 256)))
    codec = FusedVideoCodec(1.0, device=device).train(y[:2])
    blob = codec.encode_to_container(y)
    calls = []
    real = tfv.decode_blocks_hot

    def spy(*args):
        calls.append(dict(zip(WALK_ARGS, args)))
        return real(*args)

    monkeypatch.setattr(tfv, "decode_blocks_hot", spy)
    _, ok = FusedVideoCodec.decode_from_container(blob, device=device)
    assert bool(ok) and len(calls) == 2
    return {"mv": calls[0], "residual": calls[1]}


def walk(fn, c):
    """``fn`` (a walk of the port) on the arguments ``c``, named as in ``WALK_ARGS``."""
    return fn(*(c[k] for k in WALK_ARGS))


def port_args(c, device="cpu") -> dict:
    """The arguments as the port takes them: tensors on ``device`` (words as
    int64) and ints."""
    return {k: to_torch(v).to(device) if isinstance(v, np.ndarray) else v for k, v in c.items()}




def captured_canon_walks(monkeypatch, device="cpu") -> dict:
    """The arguments of the canonical walks (``decode_blocks_device``) that
    the decoders run at 128x256: a lena crop's RGB ``IntraCodec`` container
    ("intra") and a 3-frame ``VideoCodec`` container (its MV section
    "video mv", then each frame's residual section "video residual t").
    Each is a dict: words, offsets, counts, tables, max_syms, max_count."""
    from ivclab_tpu_torch import IntraCodec, VideoCodec
    from ivclab_tpu_torch.models import videocodec as tvc
    from ivclab_tpu_torch.ops import transform as ttf
    from ivclab_tpu_torch.utils import fixtures

    calls = []
    real = ttf.decode_blocks_device

    def spy(words, offsets, counts, tables, max_syms, max_count=None):
        calls.append({"words": words, "offsets": offsets, "counts": counts, "tables": tables,
                      "max_syms": max_syms, "max_count": max_count})
        return real(words, offsets, counts, tables, max_syms, max_count)

    monkeypatch.setattr(ttf, "decode_blocks_device", spy)  # the coded sections
    monkeypatch.setattr(tvc, "decode_blocks_device", spy)  # the MV section
    img = np.ascontiguousarray(fixtures.image("lena")[:128, :256])
    intra = IntraCodec(1.0, device=device)
    intra.train_huffman_from_image(img)
    IntraCodec.decode_from_container(intra.encode_to_container(img), device=device)
    y = luma(fixtures.video("foreman", 3, (128, 256)))
    blob = VideoCodec(1.0, device=device).encode_to_container(y)
    _, oks = VideoCodec.decode_from_container(blob, return_device=True, device=device)
    assert bool(oks.all()) and len(calls) == 5
    names = ["intra", "video mv"] + [f"video residual {t}" for t in range(3)]
    return dict(zip(names, calls))
