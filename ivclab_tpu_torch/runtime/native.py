"""The C++ serial entropy engine, loaded with ctypes.

Port of ``ivclab_tpu/runtime/native.py``. ``csrc/entropy.cpp`` is compiled
at first use by ``cuda_build.build_host`` (``g++ -O3 -std=c++17 -shared
-fPIC``) into the git-ignored ``csrc/_build/``, keyed by a hash of the
source and the flags; concurrent first builds are safe (see
``cuda_build``). It is the host engine for the Huffman facade (serial
pack and canonical decode), the Huffman tree's depth loop and its length
limit, and the serial zero-run oracle of the tensor paths.

Where the engine runs:

- where ``g++`` is on ``PATH`` the library is built and every entry point
  runs in C++; a compile that fails raises ``RuntimeError`` with g++'s
  stderr, on every call, and is never replaced by the numpy path;
- where there is no ``g++`` at all, ``pack_bits`` and ``decode_symbols``
  take their numpy versions (``_pack_bits_np``, ``_decode_symbols_np``),
  ``huffman_depths`` and ``limit_bits`` return None (the caller runs its
  numpy loop), and the zero-run oracles raise.

:func:`available` and :func:`unavailable_reason` say which case holds.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ivclab_tpu_torch.runtime import cuda_build

_lock = threading.Lock()
_lib = None
_missing: str | None = None  # set once, only when there is no g++


def _load(build_dir: Path = cuda_build.BUILD_DIR):
    """Build and load the engine: ``(lib, None)``, or ``(None, reason)``
    where there is no ``g++``. A failed compile raises ``RuntimeError``."""
    try:
        path, _ = cuda_build.build_host(cuda_build.CSRC / "entropy.cpp", build_dir)
    except FileNotFoundError as e:
        return None, f"native engine unavailable: {e}"
    lib = ctypes.CDLL(str(path))
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS,WRITEABLE")
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32

    lib.ivc_pack_bits.restype = i64
    lib.ivc_pack_bits.argtypes = [u32p, i32p, i64, u32p]
    lib.ivc_decode_symbols.restype = i64
    lib.ivc_decode_symbols.argtypes = [u32p, i64, i64, i64, u32p, u32p, i32p, i32p, i32, i32, i32p]
    lib.ivc_zerorun_encode.restype = i64
    lib.ivc_zerorun_encode.argtypes = [i32p, i64, i32, i32, i32p]
    lib.ivc_zerorun_decode.restype = i64
    lib.ivc_zerorun_decode.argtypes = [i32p, i64, i64, i32, i32, i32p]
    lib.ivc_huffman_depths.restype = i64
    lib.ivc_huffman_depths.argtypes = [f64p, i64, i32p]
    lib.ivc_limit_lengths.restype = i64
    lib.ivc_limit_lengths.argtypes = [i64p, i32, i32]
    return lib, None


def get_lib():
    """The loaded library, or None where there is no ``g++``.

    Raises ``RuntimeError`` with g++'s stderr when the compile fails; that
    failure is not remembered, so a later call tries again.
    """
    global _lib, _missing
    with _lock:
        if _lib is None and _missing is None:
            _lib, _missing = _load()
        return _lib


def available() -> bool:
    """True when the C++ engine is built and loaded."""
    try:
        return get_lib() is not None
    except RuntimeError:
        return False


def unavailable_reason() -> str | None:
    """None when the engine is loaded; else why not: no ``g++`` (the numpy
    path runs), or the failed compile with g++'s stderr (entry points raise)."""
    try:
        return None if get_lib() is not None else _missing
    except RuntimeError as e:
        return str(e)


# ---------------------------------------------------------------- pack bits

def pack_bits(codes: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, int]:
    """Serial MSB-first pack; returns (u32 words, total_bits)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint32)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    cap = (int(np.sum(lens.clip(min=0))) + 31) // 32 + 1
    out = np.zeros(max(cap, 1), dtype=np.uint32)
    lib = get_lib()
    if lib is not None:
        total = lib.ivc_pack_bits(codes, lens, codes.size, out)
    else:
        total = _pack_bits_np(codes, lens, out)
    nwords = (int(total) + 31) // 32
    return out[: max(nwords, 0)], int(total)


def _pack_bits_np(codes, lens, out):
    bitpos = 0
    for c, l in zip(codes.tolist(), lens.tolist()):
        if l <= 0:
            continue
        lj = (int(c) << (32 - l)) & 0xFFFFFFFF if l < 32 else int(c)
        w, sh = bitpos >> 5, bitpos & 31
        out[w] |= (lj >> sh) & 0xFFFFFFFF
        if sh:
            out[w + 1] |= (lj << (32 - sh)) & 0xFFFFFFFF
        bitpos += l
    return bitpos


# ------------------------------------------------------------ decode symbols

def decode_symbols(words: np.ndarray, num_symbols: int, code, start_bit: int = 0) -> np.ndarray:
    """Serial canonical decode -> 0-based alphabet indices."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    out = np.empty(num_symbols, dtype=np.int32)
    lib = get_lib()
    fc = np.ascontiguousarray(code.first_code, dtype=np.uint32)
    go = np.ascontiguousarray(code.group_offset, dtype=np.int32)
    ss = np.ascontiguousarray(code.sorted_syms, dtype=np.int32)
    lj = np.ascontiguousarray(code.lj_next_minus1, dtype=np.uint32)
    if lib is not None:
        used = lib.ivc_decode_symbols(
            words, words.size, start_bit, num_symbols, lj, fc, go, ss, ss.size,
            code.min_len, out
        )
        if used < 0:
            raise ValueError("canonical decode failed: corrupt bitstream")
        return out
    return _decode_symbols_np(words, num_symbols, lj, fc, go, ss, start_bit, code.min_len)


def _decode_symbols_np(words, num_symbols, lj, fc, go, ss, start_bit, min_len=1):
    out = np.empty(num_symbols, dtype=np.int32)
    bitpos = start_bit
    total_bits = words.size * 32
    for i in range(num_symbols):
        if bitpos >= total_bits:
            raise ValueError("canonical decode failed: stream exhausted")
        w, sh = bitpos >> 5, bitpos & 31
        window = (int(words[w]) << sh) & 0xFFFFFFFF
        if sh and w + 1 < words.size:
            window |= int(words[w + 1]) >> (32 - sh)
        length = min_len
        while length < 32 and window > int(lj[length - 1]):
            length += 1
        code_val = window >> (32 - length) if length < 32 else window
        pos = int(go[length]) + code_val - int(fc[length])
        if pos < 0 or pos >= ss.size:
            raise ValueError("canonical decode failed: corrupt bitstream")
        out[i] = ss[pos]
        bitpos += length
    return out


# ------------------------------------------------------------ huffman depths

def huffman_depths(leaf_w_sorted: np.ndarray) -> np.ndarray | None:
    """Two-queue prefix-code depths for ascending-sorted leaf weights.

    The same merge order and tie-breaking as the numpy loop in
    ``entropy/codebook.py``; None where there is no ``g++`` (the caller
    runs that loop).
    """
    lib = get_lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(leaf_w_sorted, dtype=np.float64)
    out = np.empty(w.size, dtype=np.int32)
    if lib.ivc_huffman_depths(w, w.size, out) != 0:
        raise ValueError("huffman_depths: need at least one leaf")
    return out


# -------------------------------------------------------------- length limit

def limit_bits(bits: np.ndarray, max_len: int) -> int | None:
    """Rebalance a code-length histogram in place so no length exceeds
    ``max_len``; returns the number of pair moves.

    ``bits[l]`` counts the codes of length ``l`` (a C-contiguous int64
    array, ``bits[0] == 0``). The same loop, in the same order, as
    ``_limit_bits_np`` in ``entropy/codebook.py``; None where there is no
    ``g++`` (the caller runs that loop). Raises ``ValueError`` where the
    histogram cannot be limited (more codes than ``2**max_len``).
    """
    lib = get_lib()
    if lib is None:
        return None
    moves = lib.ivc_limit_lengths(bits, bits.size - 1, max_len)
    if moves < 0:
        raise ValueError(f"limit_bits: more codes than 2**{max_len}")
    return int(moves)


# ---------------------------------------------------------------- zero-run

def zerorun_encode(blocks: np.ndarray, eob: int) -> np.ndarray:
    """Serial zero-run encode of [N, block_size] -> compact symbol stream."""
    blocks = np.ascontiguousarray(blocks, dtype=np.int32)
    n, bs = blocks.shape
    out = np.empty(n * (bs // 2 * 3 + 2), dtype=np.int32)
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native engine unavailable (use the tensor path)")
    k = lib.ivc_zerorun_encode(blocks, n, bs, eob, out)
    return out[:k].copy()


def zerorun_decode(symbols: np.ndarray, nblocks: int, block_size: int, eob: int) -> np.ndarray:
    """Serial zero-run decode -> [nblocks, block_size]."""
    symbols = np.ascontiguousarray(symbols, dtype=np.int32)
    out = np.zeros((nblocks, block_size), dtype=np.int32)
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native engine unavailable (use the tensor path)")
    used = lib.ivc_zerorun_decode(symbols, symbols.size, nblocks, block_size, eob, out)
    if used < 0:
        raise ValueError("zero-run decode failed: corrupt stream")
    return out
