"""Structured stage tracing and profiling.

Port of ``ivclab_tpu/runtime/trace.py``: named stage timers that
synchronise the device before they stop the clock, optional
``torch.profiler.record_function`` annotations (they name the stage in a
profiler trace), a JSON report, and :func:`device_trace`, a
``torch.profiler`` capture written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

import torch


def _synchronize(sync) -> None:
    """Wait for the CUDA devices that hold the tensor(s) ``sync``; a CPU
    tensor needs no wait."""
    tensors = sync if isinstance(sync, (tuple, list)) else (sync,)
    for dev in {t.device for t in tensors}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates wall time per named stage; device-synced on exit."""

    def __init__(self, enabled: bool = True, annotate: bool = True):
        self.enabled = enabled
        self.annotate = annotate
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage. ``sync`` is a tensor, or a tuple of tensors, whose
        CUDA device is synchronised before the clock stops; a failed
        synchronisation raises."""
        if not self.enabled:
            yield
            return
        ctx = torch.profiler.record_function(name) if self.annotate else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
            if sync is not None:
                _synchronize(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "calls": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 2),
            }
            for name in sorted(self.totals)
        }

    def dump(self) -> str:
        return json.dumps(self.report(), indent=2)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the enclosed region over the CPU and, where there is a card,
    CUDA activities; write it into ``logdir`` as ``trace.json`` (Chrome
    trace format, opened by ``chrome://tracing`` or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
