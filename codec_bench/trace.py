"""The traced slice of a window: ``torch.profiler`` over a bounded number of
GOPs, read back from its Chrome trace.

Every device operation (kernel, copy, fill) is tied to the host call that
launched it through the trace's correlation ids, and from the launch's host
time to the benchmark's spans around it: the GOP (``cb.gop/<i>``) and the
call into the port (``cb.<call>``). A slice is the span ``cb.slice``, from
the profiler's start (after a lead-in) to the host seeing the last traced
GOP's completion.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def kernel_base_name(name: str) -> str:
    """A kernel's own name without namespaces, template arguments,
    parameters and return type, also from an Itanium-mangled name (a copy
    of ``ivclab_tpu_torch/utils/timing.py::kernel_base_name``)."""
    if name.startswith("_Z"):
        i, last = 2 + (name[2:3] == "N"), name
        while i < len(name) and name[i].isdigit():
            j = i
            while j < len(name) and name[j].isdigit():
                j += 1
            last, i = name[j:j + int(name[i:j])], j + int(name[i:j])
        return last
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0].split("<", 1)[0]
    return head.rsplit("::", 1)[-1].split()[-1] if head.strip() else name


class Slice:
    """Profile the GOPs dispatched between :meth:`start` and :meth:`stop`
    (on a CPU device, for rehearsals, the host's spans alone)."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.device(device).type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.span = None

    def _drain(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._drain()
        self.prof.__enter__()
        if self.cuda:
            # a lead-in: on the H100 a trace has come back without its
            # first device events, so the slice opens after a spin kernel
            lead = torch.zeros(1, device="cuda")
            for _ in range(32):
                lead.add_(1)
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
        self.span = torch.profiler.record_function("cb.slice")
        self.span.__enter__()

    def stop(self) -> dict:
        """End the slice, drain the device, and read the trace."""
        self.span.__exit__(None, None, None)
        self._drain()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return read_events(events)


def read_events(events: list[dict]) -> dict:
    """Chrome-trace events -> the slice: its window, every device operation
    with its GOP and call, and the host spans."""
    launch_ts, device, spans = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in LAUNCH_CATS and corr is not None:
            launch_ts[corr] = float(e["ts"])
        elif cat in DEVICE_CATS:
            device.append(e)
        elif cat == "user_annotation" and e.get("name", "").startswith("cb."):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]))
    window = next(((a, b) for a, b, n in spans if n == "cb.slice"), None)
    if window is None:
        raise RuntimeError("the trace holds no cb.slice span")
    gops = sorted((a, b, int(n.split("/", 1)[1])) for a, b, n in spans if n.startswith("cb.gop/"))
    calls = sorted((a, b, n) for a, b, n in spans
                   if n != "cb.slice" and not n.startswith("cb.gop/"))

    def inside(sorted_spans, t):  # the spans of one kind do not overlap
        i = bisect.bisect_right(sorted_spans, (t, float("inf"))) - 1
        if i >= 0 and sorted_spans[i][0] <= t <= sorted_spans[i][1]:
            return sorted_spans[i][2]
        return None

    ops = []
    for e in device:
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        lt = launch_ts.get((e.get("args") or {}).get("correlation"))
        ops.append({
            "name": kernel_base_name(e.get("name", "")),
            "cat": e.get("cat"),
            "ts": ts,
            "dur_us": dur,
            "gop": None if lt is None else inside(gops, lt),
            "call": None if lt is None else inside(calls, lt),
        })
    ops.sort(key=lambda o: o["ts"])
    return {"window": window, "ops": ops, "calls": calls}


def busy_intervals(ops: list[dict], window) -> list[tuple[float, float]]:
    """Merged intervals (us) in which some device operation ran, clipped to
    the window."""
    a0, b0 = window
    ivs = sorted((max(o["ts"], a0), min(o["ts"] + o["dur_us"], b0)) for o in ops)
    merged: list[list[float]] = []
    for a, b in ivs:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def breakdown(sl: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle gaps summed
    by the call the host was in when the device went idle (or ``host`` when
    it was in none), both in seconds."""
    window = sl["window"]
    by_name: dict[str, float] = defaultdict(float)
    for o in sl["ops"]:
        if window[0] <= o["ts"] <= window[1]:
            by_name[o["name"]] += o["dur_us"] * 1e-6
    busy = busy_intervals(sl["ops"], window)
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    gaps: dict[str, float] = defaultdict(float)
    calls = sl["calls"]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = "host"
        for ca, cb, n in calls:  # innermost call open at the gap's start
            if ca <= a <= cb:
                label = n
        gaps[label] += (b - a) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_name), "idle_gaps": rank(gaps)}
