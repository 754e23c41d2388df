"""The port's recorder of spans and counters, stage timers, and profiling.

One recorder, :data:`RECORDER`, holds what the port's hot paths mark:

- :func:`span` names a region: its start and end on the host, its parent
  span, and a request id shared by every span under one outermost call
  into the port. A span opened with ``device=`` a CUDA device also records
  a CUDA event at each end, read back only once its work has run.
- :func:`count` adds to the innermost open span and to the totals
  (``syncs``, ``d2h_bytes``, ``h2d_bytes``).

The recorder is off by default. Off, :func:`span` checks one flag and
returns the shared no-op context manager :data:`NOOP`: it allocates
nothing, takes no timestamp and never synchronises. It is on after
:func:`enable` and while a ``torch.profiler`` records (the flag
``torch.autograd.profiler._is_profiler_enabled``, which the profiler sets
on entry and clears on exit). While a profiler records, every span is also
a ``record_function``, so it appears as a ``user_annotation`` in the
profiler's trace, on the same timeline as the device's operations.

Spans stay in memory, in a bounded buffer that counts what it drops, and
are read back by :func:`requests` and :func:`summary`; nothing is written
on the hot path. The host clock is ``time.time_ns()``, the profiler's: a
Chrome trace's ``ts`` is ``(t0_ns - baseTimeNanoseconds) / 1e3``. Reading
the recorder while it is off ends its session: the next span recorded
starts a new one, so a second profiler run does not read the first's.

Also here: :class:`StageTimer`, named stages that synchronise the device
before the clock stops (the CLI's ``--trace``), each stage a span of the
recorder; and :func:`device_trace`, a ``torch.profiler`` capture written as
a Chrome trace. Port of ``ivclab_tpu/runtime/trace.py`` (the timers).

    from ivclab_tpu_torch.runtime import trace
    trace.enable()
    ...                                  # the port's calls
    print(trace.summary())               # {"names": {name: {host_ms, calls}}, "counts": ...}
    trace.disable()
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 16  # closed spans a session keeps; later ones are dropped and counted


class _Noop:
    """What :func:`span` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    """One open, then closed, span of the recorder."""

    __slots__ = ("rec", "name", "id", "parent", "request", "t0_ns", "t1_ns", "counts",
                 "events", "annotation")

    def __init__(self, rec: Recorder, name: str, device, annotate: bool):
        self.rec = rec
        self.name = name
        self.counts = None
        self.events = None
        self.annotation = None
        self.t1_ns = None
        if device is not None and torch.device(device).type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        if annotate and _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(name)

    def __enter__(self):
        self.rec._push(self)
        self.t0_ns = time.time_ns()
        if self.annotation is not None:
            self.annotation.__enter__()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.t1_ns = time.time_ns()
        self.rec._pop(self)
        return False

    def device_ms(self) -> float | None:
        """Device ms between the span's two events, once both have run
        (never waits for them); ``None`` without events."""
        if self.events is None or not self.events[1].query():
            return None
        return self.events[0].elapsed_time(self.events[1])


class Recorder:
    """Spans and counters of the port's hot paths (see the module's
    docstring). Past :data:`MAX_SPANS` closed spans a session drops spans
    and counts them; the totals still count them."""

    def __init__(self):
        self.enabled = False
        self._local = threading.local()  # each thread's stack of open spans
        self._lock = threading.Lock()  # the session's buffer and totals
        self._ids = itertools.count(1)
        self._reset()

    def _reset(self) -> None:
        self.closed: list[_Span] = []
        self.dropped = 0
        self.totals: dict[str, int] = defaultdict(int)
        self.span_totals: dict[str, list] = {}  # name -> [host ns, calls]
        self._fresh = False

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self, s: _Span) -> None:
        if self._fresh:
            self._reset()
        stack = self._stack()
        s.id = next(self._ids)
        if stack:
            s.parent, s.request = stack[-1].id, stack[-1].request
        else:
            s.parent, s.request = None, s.id
        stack.append(s)

    def _pop(self, s: _Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()
        elif s in stack:
            stack.remove(s)
        with self._lock:
            tot = self.span_totals.get(s.name)
            if tot is None:
                tot = self.span_totals[s.name] = [0, 0]
            tot[0] += s.t1_ns - s.t0_ns
            tot[1] += 1
            if len(self.closed) < MAX_SPANS:
                self.closed.append(s)
            else:
                self.dropped += 1

    def is_on(self) -> bool:
        return self.enabled or _autograd_profiler._is_profiler_enabled

    def open(self, name: str, device=None, annotate: bool = True) -> _Span:
        return _Span(self, name, device, annotate)

    def add(self, name: str, n: int) -> None:
        stack = self._stack()
        if stack:
            s = stack[-1]
            if s.counts is None:
                s.counts = {}
            s.counts[name] = s.counts.get(name, 0) + n
        with self._lock:
            self.totals[name] += n

    def _read(self) -> None:
        if not self.is_on():
            self._fresh = True

    def requests(self) -> list[dict]:
        """Every request recorded in this session, in order of its start:
        ``{"id", "name"`` (its outermost span's), ``"spans"}``; each span
        ``{"name", "id", "parent", "t0_ns", "t1_ns", "host_ms",
        "device_ms"`` (``None`` unless flagged and run), ``"counts"}``."""
        self._read()
        by_request: dict[int, list] = defaultdict(list)
        for s in self.closed:
            by_request[s.request].append(s)
        out = []
        for rid, spans in by_request.items():
            spans.sort(key=lambda s: s.t0_ns)
            root = next((s for s in spans if s.id == rid), spans[0])
            out.append({"id": rid, "name": root.name, "spans": [{
                "name": s.name, "id": s.id, "parent": s.parent, "t0_ns": s.t0_ns,
                "t1_ns": s.t1_ns, "host_ms": (s.t1_ns - s.t0_ns) / 1e6,
                "device_ms": s.device_ms(), "counts": dict(s.counts or {}),
            } for s in spans]})
        out.sort(key=lambda r: r["spans"][0]["t0_ns"])
        return out

    def summary(self) -> dict:
        """``{"names": {span name: {"host_ms", "calls"}}, "counts": {counter:
        total}, "dropped": spans dropped}`` over the session."""
        self._read()
        rep = {name: {"host_ms": round(ns / 1e6, 3), "calls": calls}
               for name, (ns, calls) in sorted(self.span_totals.items())}
        return {"names": rep, "counts": dict(self.totals), "dropped": self.dropped}


RECORDER = Recorder()


def span(name: str, device=None):
    """A span of the recorder named ``name`` (a context manager); with
    ``device`` a CUDA device it also times the device between its ends.
    Off, the shared :data:`NOOP`."""
    if RECORDER.enabled or _autograd_profiler._is_profiler_enabled:
        return RECORDER.open(name, device)
    return NOOP


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span and of the
    totals; nothing while the recorder is off."""
    if RECORDER.enabled or _autograd_profiler._is_profiler_enabled:
        RECORDER.add(name, n)


def fetch(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()`` inside an ``ivc.fetch`` span: from a CUDA device it is a
    host synchronisation and a copy, counted in ``syncs`` and ``d2h_bytes``."""
    with span("ivc.fetch"):
        out = t.cpu()
        if t.is_cuda:
            count("syncs")
            count("d2h_bytes", out.nbytes)
    return out


def upload_pageable(t: torch.Tensor, device) -> torch.Tensor:
    """``t.to(device)`` from pageable host memory inside an ``ivc.fetch``
    span: to a CUDA device the copy waits for the card as a read does,
    counted in ``syncs`` and ``h2d_bytes``."""
    with span("ivc.fetch"):
        out = t.to(device)
        if out.is_cuda:
            count("syncs")
            count("h2d_bytes", t.nbytes)
    return out


def enable() -> bool:
    """Turn the recorder on and start a new session; returns whether it was
    on already."""
    was = RECORDER.enabled
    RECORDER.enabled = True
    RECORDER._reset()
    return was


def disable() -> None:
    RECORDER.enabled = False


def reset() -> None:
    """Forget every span and counter of the session."""
    RECORDER._reset()


def requests() -> list[dict]:
    return RECORDER.requests()


def summary() -> dict:
    return RECORDER.summary()


def _synchronize(sync) -> None:
    """Wait for the CUDA devices that hold the tensor(s) ``sync``; a CPU
    tensor needs no wait."""
    tensors = sync if isinstance(sync, (tuple, list)) else (sync,)
    for dev in {t.device for t in tensors}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates wall time per named stage; device-synced on exit. Each
    stage is also a span of the recorder (named in a profiler's trace
    where ``annotate``)."""

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
        t0 = time.perf_counter()
        with RECORDER.open(name, annotate=self.annotate) if RECORDER.is_on() else NOOP:
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
