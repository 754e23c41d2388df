"""Timing on the card: CUDA events around a loop, and kernel device time
from ``torch.profiler``.

A wrapper call enqueues its kernel from Python, which takes longer than a
kernel of a few microseconds runs, so events around a loop of calls time
the host. :func:`kernel_device_us` reads each launch's own duration from
the profiler's device trace instead.
"""

from __future__ import annotations

import numpy as np
import torch

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA's data
# sheet): FP32 on the CUDA cores, an FMA counted as two operations; HBM3.
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def motion_search_bound(ref_rows: int, H: int, W: int, sr: int) -> tuple[float, str]:
    """(least ms, "operations" or "bytes") for one full search of an
    ``[H, W]`` current plane against a ``[ref_rows, W]`` reference on the
    H100: every block's (2 sr + 1)^2 candidates at 64 subtract, multiply
    and add triples each, against each input read once and the int32
    indices written once."""
    blocks = (H // 8) * (W // 8)
    ops = blocks * (2 * sr + 1) ** 2 * 64 * 3
    nbytes = (ref_rows + H) * W * 4 + blocks * 4
    op_ms = ops / H100_FP32_FLOPS * 1e3
    byte_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def decode_walk_bound(block_bits, LW: int, max_syms: int) -> tuple[float, str]:
    """(least ms, "bytes") for one hot/escape decode walk on the H100.

    ``block_bits`` holds each block's bits walked (``[B]``, as
    ``decode_blocks_hot_plain(..., return_bits=True)`` gives them): of the
    block's row of ``LW`` int64 words (rows from a 32-byte boundary), the
    walk must read the 32-byte sectors of the ``ceil(bits / 32)`` words
    those bits lie in. Each block's int32 count is read once and its
    ``max_syms`` int32 outputs are written once. The code tables (a few
    hundred bytes) and the walk's integer work, a few dozen instructions
    per decoded symbol, are far below that."""
    bits = np.asarray(block_bits, dtype=np.int64).reshape(-1)
    words = np.minimum((bits + 31) // 32, LW)
    start = np.arange(bits.size, dtype=np.int64) * (LW * 8)
    sectors = np.where(words > 0, (start + words * 8 + 31) // 32 - start // 32, 0)
    nbytes = int(sectors.sum()) * 32 + bits.size * (4 + max_syms * 4)
    return nbytes / H100_HBM_BYTES_PER_S * 1e3, "bytes"


def canon_walk_bound(block_offsets, block_bits, n_words: int, max_syms: int
                     ) -> tuple[float, str]:
    """(least ms, "bytes") for one canonical decode walk of an ``n_words``
    int64 word stream on the H100.

    ``block_offsets`` and ``block_bits`` hold each block's first bit and
    its bits walked (``[B]``, as ``decode_blocks_device_plain(...,
    return_bits=True)`` gives them), offsets inside the stream: the walk
    must read the 32-byte sectors of the words those bits lie in, each
    sector once however many blocks share it (the stream starts on a
    32-byte boundary). Each block's int32 offset and count are read once and
    its ``max_syms`` int32 outputs are written once. The code tables (a few
    hundred bytes to a few KiB) and the walk's integer work, a few dozen
    instructions per decoded symbol, are far below that."""
    offs = np.asarray(block_offsets, dtype=np.int64).reshape(-1)
    bits = np.asarray(block_bits, dtype=np.int64).reshape(-1)
    walked = bits > 0
    first = np.clip(offs[walked] >> 5, 0, n_words - 1) // 4
    last = np.clip((offs[walked] + bits[walked] - 1) >> 5, 0, n_words - 1) // 4
    n_sectors = -(-n_words // 4)
    edge = np.zeros(n_sectors + 1, dtype=np.int64)
    np.add.at(edge, first, 1)
    np.add.at(edge, last + 1, -1)
    sectors = int((np.cumsum(edge[:-1]) > 0).sum())
    nbytes = sectors * 32 + offs.size * (8 + max_syms * 4)
    return nbytes / H100_HBM_BYTES_PER_S * 1e3, "bytes"


def grouped_pack_bound(N: int, S: int, G: int, wpg: int, len_bytes: int = 4
                       ) -> tuple[float, str]:
    """(least ms, "bytes") for one grouped pack (``ops/bitpack.py::
    pack_codes_grouped_dense``) of ``[N, S]`` slots into ``G`` groups of
    ``wpg`` words on the H100: the int64 codes and the lengths
    (``len_bytes`` each) read once; the int64 words, the int32 block
    offsets and the int32 group bits written once. The deposit's integer
    work, a few dozen instructions a coded slot, is far below that."""
    nbytes = N * S * (8 + len_bytes) + G * wpg * 8 + N * 4 + G * 4
    return nbytes / H100_HBM_BYTES_PER_S * 1e3, "bytes"


def hot_map_bound(N: int, cap: int, K: int = 0) -> tuple[float, str]:
    """(least ms, "bytes") for one map of the GOP codec's pack
    (``ops/transform.py::map_gop_hot``) of ``N`` blocks into ``cap`` slots
    on the H100: the 64 int32 symbols a block and the ``K`` int64 hot values
    and fused entries read once; the int64 codes and int32 lengths of every
    slot, the int32 count a block and the three 0-d extents (two int64, one
    bool) written once. The zero-run and the lookups, a few dozen
    instructions a block and a short search a coded slot, are far below
    that."""
    nbytes = N * 64 * 4 + K * 16 + N * cap * (8 + 4) + N * 4 + 17
    return nbytes / H100_HBM_BYTES_PER_S * 1e3, "bytes"


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` between two CUDA events around ``iters``
    calls (host enqueue included where it is the slower side)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_kernels(fn, iters: int = 1) -> list[tuple[str, float]]:
    """(name, duration in us) of every device kernel (and copy) that
    ``iters`` calls of ``fn`` launch, from a ``torch.profiler`` trace.

    On the H100 a trace taken late in a process has come back without
    some of the first device events of its session (7 to 24 of a decode's
    uploads and kernels, an intra decode's walk among them). So each trace
    opens with a lead-in, 32 small kernels and a spin kernel, and only the
    events that start after the spin kernel's end are kept (all but the
    spin kernel where the trace lost it too); with the lead-in, every trace
    of a decode held the same events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lead = torch.zeros(1, device="cuda")
        for _ in range(32):
            lead.add_(1)
        torch.cuda._sleep(100_000)  # a spin kernel, ~50 us at 1.98 GHz
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spins = [e for e in events if "spin_kernel" in e.name]
    if spins:
        start = max(e.time_range.end for e in spins)
        events = [e for e in events if e.time_range.start >= start]
    return [(e.name, e.time_range.elapsed_us()) for e in events if "spin_kernel" not in e.name]


def event_device_us(fn, iters: int) -> list[float]:
    """Device time in us of each of ``iters`` calls of ``fn``, between two
    CUDA events that a spin kernel holds back until the host has enqueued
    the call, so the host's enqueue is not in it (the events' own overhead,
    a few us, is)."""
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # ~1 ms at 1.98 GHz, far longer than an enqueue
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) * 1e3)
    return out


def kernel_base_name(name: str) -> str:
    """A kernel's own name from the name a profiler trace gives it:
    without its namespaces, template arguments, parameters and return type
    (``void (anonymous namespace)::me_kernel<4>(float const*, ...)`` ->
    ``me_kernel``), also from an Itanium-mangled name."""
    if name.startswith("_Z"):  # _Z[N]<length><identifier>... up to E or I
        i, last = 2 + (name[2:3] == "N"), name
        while i < len(name) and name[i].isdigit():
            j = i
            while j < len(name) and name[j].isdigit():
                j += 1
            last, i = name[j:j + int(name[i:j])], j + int(name[i:j])
        return last
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0].split("<", 1)[0]
    return head.rsplit("::", 1)[-1].split()[-1] if head.strip() else name


def kernel_device_us(fn, iters: int, match: str) -> list[float]:
    """Device durations in us of the kernels named ``match`` (their
    :func:`kernel_base_name`) over ``iters`` calls of ``fn``, from a
    ``torch.profiler`` trace. On the
    H100 a trace has come back without any device event, twice in a row in
    one process; so when two traces in turn hold none of the kernel, the
    calls are timed by :func:`event_device_us` instead, with a warning."""
    import warnings

    for _ in range(2):
        kernels = device_kernels(fn, iters)
        durations = [us for name, us in kernels if kernel_base_name(name) == match]
        if durations:
            return durations
    warnings.warn(f"the profiler's traces hold {len(kernels)} device events and no {match!r}: "
                  f"timed with CUDA events instead")
    return event_device_us(fn, iters)


def host_syncs(fn) -> list[tuple[str, int]]:
    """(``file:line``, count) of every point where one call of ``fn`` makes
    the host wait for the card, in order of first appearance, counted under
    ``torch.cuda.set_sync_debug_mode("warn")``: reads of device values,
    device-to-host copies and pageable host-to-device copies. Each sync is
    placed at the innermost frame in this package that led to it."""
    import traceback
    import warnings
    from collections import Counter
    from pathlib import Path

    package = Path(__file__).resolve().parents[1]
    where = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        for frame in reversed(traceback.extract_stack()[:-1]):
            path = Path(frame.filename).resolve()
            if package in path.parents:
                where[f"{path.relative_to(package.parent)}:{frame.lineno}"] += 1
                return
        where[f"{filename}:{lineno}"] += 1

    torch.cuda.synchronize()
    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(previous)
    torch.cuda.synchronize()
    return list(where.items())
