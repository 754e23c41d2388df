"""Timing on the card: CUDA events around a loop, and kernel device time
from ``torch.profiler``.

A wrapper call enqueues its kernel from Python, which takes longer than a
kernel of a few microseconds runs, so events around a loop of calls time
the host. :func:`kernel_device_us` reads each launch's own duration from
the profiler's device trace instead.
"""

from __future__ import annotations

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
    """(name, duration in us) of every device kernel that ``iters`` calls
    of ``fn`` launch, from a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def kernel_device_us(fn, iters: int, match: str) -> list[float]:
    """Device durations in us of the kernels whose name contains ``match``
    over ``iters`` calls of ``fn``; raises if the trace holds none."""
    durations = [us for name, us in device_kernels(fn, iters) if match in name]
    if not durations:
        raise RuntimeError(f"the profiler traced no kernel named like {match!r}")
    return durations
