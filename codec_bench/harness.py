"""One run of one cell: set-up, the timed window, the check, the result line.

Everything a cell is made of is found by its name in ``BENCHMARK.json``,
under ``codec_bench/`` beside the manifest: the configuration's file (its
``file``) and the codec it names (``codec/<codec>/program.py``, the calls
into the port; ``codec/<codec>/judge.py``, the reference's side of its
check) and its input kind (``inputs/<input>.py``; ``luma_gops`` where it
names none), the traffic mix ``traffic/<traffic>.json`` and the loop it
names (``loops/<loop>.py``), the limits of its check
``limits/<cell>.json`` and each per-layer metric's reader
``metrics/<metric>.py``. A GOP below is the unit the input kind makes and
a step codes: a GOP of frames, or a still image. The window's loop
is closed: GOP i+1 is dispatched before the host waits on GOP i's
completion event (the mix's ``depth`` GOPs in flight), GOPs cycle through
the clip, and every ``ok`` flag stays on the device until the window has
closed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from codec_bench import checks, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "ivclab_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the port must never load,
    compared whole (``ivclab_tpu_torch`` is not ``ivclab_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load(path: Path, name: str):
    """The module in the file ``path``, which must exist."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(f"codec_bench_file_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spans:
    """Named spans around calls into the port: ``record_function`` for the
    profiler and the host milliseconds each call took, per name."""

    def __init__(self):
        self.ms: dict[str, list[float]] = defaultdict(list)

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.ms[name].append(1e3 * (time.perf_counter() - t0))


class Cell:
    """A cell's manifest entries and files, found by name."""

    def __init__(self, manifest_path: Path, workload: str):
        self.root = Path(manifest_path).resolve().parent
        self.manifest = json.loads(Path(manifest_path).read_text())
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in {manifest_path}")
        self.entry = cells[workload]
        conf = {c["name"]: c for c in self.manifest["configs"]}[self.entry["config"]]
        self.cfg = json.loads((self.root / conf["file"]).read_text())
        bench = self.root / "codec_bench"
        self.traffic = json.loads((bench / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
        codec = bench / "codec" / self.cfg["codec"]
        self.program = load(codec / "program.py", f"{self.cfg['codec']}_program").Program
        self.judge = load(codec / "judge.py", f"{self.cfg['codec']}_judge")
        kind = self.cfg.get("input", "luma_gops")
        self.input = load(bench / "inputs" / f"{kind}.py", f"input_{kind}")
        self.loop = load(bench / "loops" / f"{self.traffic['loop']}.py", self.traffic["loop"])
        self.per_layer = [m for m in self.manifest["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.end_to_end = [m for m in self.manifest["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.metric_files = {m["name"]: bench / "metrics" / f"{m['name']}.py"
                             for m in self.manifest["per_layer"]}

    def reader(self, metric: str):
        return load(self.metric_files[metric], f"metric_{metric}").read


def verdict(numbers: dict, limits: dict, failed: int) -> tuple[dict, bool]:
    """Each number the check compared beside its limit (a number the check
    could not read counts as broken), and whether every one holds."""
    checked = {k: {"value": _finite(numbers.get(k, math.inf)), "limit": limits[k]}
               for k in limits}
    checked["failed_gops"] = {"value": failed, "limit": 0}
    return checked, bool(numbers) and all(v["value"] <= v["limit"] for v in checked.values())


class Keeper:
    """Copies the outputs of the GOPs the check will judge to the host as
    they complete, on a side stream into pinned buffers reserved in set-up,
    so that keeping them holds no device memory and stalls no GOP."""

    def __init__(self, dev: torch.device):
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.free: list[dict] = []

    def reserve(self, example: dict, n: int) -> None:
        if self.stream is None:
            return
        for _ in range(n):
            self.free.append({k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                              for k, v in example.items() if isinstance(v, torch.Tensor)})

    def keep(self, out: dict, done_event) -> dict:
        if self.stream is None:
            return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in out.items()}
        bufs = self.free.pop()
        self.stream.wait_event(done_event)
        with torch.cuda.stream(self.stream):
            for k, v in out.items():
                if isinstance(v, torch.Tensor):
                    bufs[k].copy_(v, non_blocking=True)
                    v.record_stream(self.stream)
        return {k: bufs[k] if isinstance(v, torch.Tensor) else v for k, v in out.items()}

    def finish(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()


class Context:
    """What a per-layer metric's reader reads: the traced slice, the host
    time of every call into the port, and the work the kernels' rooflines
    count."""

    def __init__(self, cell: Cell, sl: dict | None, n_traced: int, host_ms: list[dict],
                 walks: dict | None, n_clip: int):
        self.cfg = cell.cfg
        self.slice = sl
        self.n_traced = n_traced
        self.host_ms = host_ms  # one {call: ms} per GOP the profiler did not see
        self.walks = walks or {}
        self.n_clip = n_clip

    def ops(self) -> list[dict]:
        """Device operations of the fully traced GOPs."""
        if not self.slice or not self.n_traced:
            return []
        return [o for o in self.slice["ops"] if o["gop"] is not None and o["gop"] < self.n_traced]

    def launches(self, kernel: str) -> list[tuple[int, int, float]]:
        """(GOP, k-th launch of ``kernel`` in its GOP, device us), in order."""
        seen: dict[int, int] = {}
        out = []
        for o in self.ops():
            if o["name"] == kernel:
                k = seen.get(o["gop"], 0)
                seen[o["gop"]] = k + 1
                out.append((o["gop"], k, o["dur_us"]))
        return out

    def walk(self, gop: int, kind: str, k: int) -> dict | None:
        """The k-th walk of ``kind`` that GOP ``gop`` of the window decodes."""
        ws = [w for w in self.walks.get(gop % self.n_clip, []) if w["kind"] == kind]
        return ws[k] if k < len(ws) else None


def _percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def run(manifest_path, workload: str, seed: int, seconds: float, trace_on: bool,
        device: str = "cuda", t_start: float | None = None, log=print):
    """One run of ``workload``. Returns the result line's dict (or raises)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(manifest_path, workload)
    cfg, mix = cell.cfg, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    n_clip = mix["clip_gops"]

    # ---------------------------------------------------------------- set-up
    clip, gops = cell.input.make(seed, cfg, n_clip, dev)
    spans = Spans()
    prog = cell.program(cfg, dev, spans)
    prog.prepare(clip, gops)
    step, blobs = cell.loop.build(prog, gops)
    depth = mix["depth"]
    rng = np.random.default_rng(seed)
    keep_idx = set(int(i) for i in rng.choice(np.arange(2, mix["check_within"]),
                                             size=mix["check_gops"], replace=False))
    keeper = Keeper(dev)
    example, info = None, {}
    for i in range(mix["warm_cycles"] * n_clip):  # every shape of the window, at its depth
        example, ok, info = step(i)
    keeper.reserve(example, len(keep_idx))
    del example
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    spans.ms.clear()
    clip_blobs = {}  # clip GOP -> container bytes the traced GOPs produced

    # ---------------------------------------------------------------- window
    sl = trace.Slice(dev) if trace_on else None
    n_trace = mix["trace_gops"] if trace_on else 0
    traced, sliced, profiled = 0, None, []
    if sl is not None:
        sl.start()
    pending: deque = deque()
    oks, lat_ms, kept = [], [], []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t_done = t0

    def complete(entry):
        nonlocal t_done, traced, sliced
        i, t_begin, ev, out = entry
        with torch.profiler.record_function("cb.wait"):
            if ev is not None:
                ev.synchronize()
        t_done = time.perf_counter()
        lat_ms.append(1e3 * (t_done - t_begin))
        if out is not None:
            kept.append(dict(keeper.keep(out, ev), gop=i % n_clip))
        if sl is not None and sliced is None and i == n_trace - 1:
            traced = n_trace
            sliced = sl.stop()

    i = 0
    while time.perf_counter() - t0 < seconds:
        t_begin = time.perf_counter()
        profiled.append(sl is not None and sliced is None)
        with torch.profiler.record_function(f"cb.gop/{i}"):
            out, ok, info = step(i)
        if "blob" in out and profiled[-1]:
            clip_blobs[i % n_clip] = out["blob"]
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        oks.append(ok)
        pending.append((i, t_begin, ev, out if i in keep_idx else None))
        del out
        i += 1
        while len(pending) >= depth:
            complete(pending.popleft())
    while pending:
        complete(pending.popleft())
    window_s = t_done - t0
    if sl is not None and sliced is None:  # the window closed inside the slice
        traced = len(lat_ms)
        sliced = sl.stop()
    keeper.finish()
    attempted = len(oks)
    ok_flags = torch.stack([torch.as_tensor(o).reshape(()) for o in oks]).cpu().numpy()
    failed = int((~ok_flags.astype(bool)).sum())
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    # every GOP makes the same calls into the port, once each
    host_ms = [{name: v[g] for name, v in spans.ms.items()}
               for g in range(attempted) if not profiled[g]]

    # ---------------------------------------------------------------- check
    del prog, step, oks, pending
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = checks.judge_kept(cell.judge, kept, gops, blobs, cfg, clip, dev) if kept else {}
    log(f"check of {len(kept)} GOPs took {time.perf_counter() - t_check:.3f} s")
    checked, correct = verdict(numbers, cell.limits, failed)

    # ---------------------------------------------------------------- metrics
    gop_pixels = cfg.get("T", 1) * cfg["H"] * cfg["W"]
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if not trace_on:
        values = {
            "mpix_per_s": (gop_pixels * len(lat_ms) / window_s / 1e6, "Mpix/s"),
            "p95_ms": (_percentile(lat_ms, 95), "ms"),
            "peak_mem_gib": (peak / 2**30, "GiB"),
            "setup_s": (setup_s, "s"),
        }
        result["metrics"] = {m["name"]: {"value": values[m["name"]][0], "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in values}
        log(f"window {window_s:.3f} s, {len(lat_ms)} GOPs, {values['mpix_per_s'][0]!r} Mpix/s, "
            f"p50 {_percentile(lat_ms, 50):.3f} ms, worst {max(lat_ms):.3f} ms, "
            f"first {lat_ms[0]:.3f} ms")
    else:
        walks = checks.walk_work(cell.judge, cfg, info, gops,
                                 clip_blobs or (dict(enumerate(blobs)) if blobs else {}), clip, dev)
        ctx = Context(cell, sliced, traced, host_ms, walks, n_clip)
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
        busy = sum(b - a for a, b in trace.busy_intervals(sliced["ops"], sliced["window"]))
        device_info["busy_s"] = busy * 1e-6
        device_info["window_s"] = (sliced["window"][1] - sliced["window"][0]) * 1e-6
        result["breakdown"] = trace.breakdown(sliced)
        log(f"traced {traced} GOPs over {device_info['window_s']:.3f} s, "
            f"{len(sliced['ops'])} device operations")
    result["device"] = device_info
    result["checks"] = checked
    return result


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300
