"""The port's recorder of spans and counters (``runtime/trace.py``).

On the CPU: off, a span records nothing and is the shared no-op; both
``enable()`` and a recording ``torch.profiler`` turn the recorder on, and it
is off again once the profiler ends; parents, request ids and counters land
on the innermost span; a CPU Chrome trace holds every ``ivc.*`` span as a
``user_annotation``, nested as recorded and on the recorder's clock; the
calls of the benchmark's three cells emit their span trees at 64x128, with
the same bytes, symbols and reconstructions whether the recorder is on or
off. On a card (``-m cuda``), the ``syncs`` counter equals what
``utils/timing.py::host_syncs`` finds, and the pack's two spans carry
device time.

This file imports neither JAX nor ``ivclab_tpu``, so it also runs on the GPU
machine, which has no JAX (tests/conftest.py imports it, hence
``--noconftest``):

    python3 -m pytest tests/test_torch_trace.py -m cuda --noconftest -q
"""

import json
import sys
import threading
import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec
from ivclab_tpu_torch.models.videocodec import VideoCodec
from ivclab_tpu_torch.runtime import trace
from ivclab_tpu_torch.utils import fixtures


@pytest.fixture(autouse=True)
def off_and_empty():
    """Every test starts and ends with the recorder off and empty."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)


def _tree(request: dict) -> list:
    """A request's spans as nested ``(name, [children])``, in order."""
    kids: dict = {}
    for s in request["spans"]:
        kids.setdefault(s["parent"], []).append(s)

    def build(pid):
        return [(s["name"], build(s["id"])) for s in kids.get(pid, [])]

    return build(None)


def test_off_a_span_records_nothing_and_is_the_shared_noop():
    assert trace.span("ivc.x") is trace.NOOP
    assert trace.span("ivc.y", device="cpu") is trace.NOOP
    with trace.span("ivc.x") as s:
        trace.count("syncs", 3)
    assert s is None
    assert trace.requests() == []
    assert trace.summary() == {"names": {}, "counts": {}, "dropped": 0}


def test_off_a_span_costs_under_a_microsecond():
    def one():
        with trace.span("ivc.x"):
            pass

    best = min(timeit.repeat(one, number=20_000, repeat=7)) / 20_000
    assert best <= 1e-6, best


def test_enable_and_a_cpu_profiler_turn_it_on_and_off():
    assert trace.span("ivc.a") is trace.NOOP
    was = trace.enable()
    assert was is False and trace.span("ivc.a") is not trace.NOOP
    trace.disable()
    assert trace.span("ivc.a") is trace.NOOP
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.span("ivc.a") is not trace.NOOP
        with trace.span("ivc.on"):
            pass
    assert trace.span("ivc.a") is trace.NOOP
    assert [r["name"] for r in trace.requests()] == ["ivc.on"]


def test_a_read_while_off_ends_the_session():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("ivc.first"):
            pass
    assert [r["name"] for r in trace.requests()] == ["ivc.first"]
    assert [r["name"] for r in trace.requests()] == ["ivc.first"]  # reads again
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("ivc.second"):
            pass
    assert [r["name"] for r in trace.requests()] == ["ivc.second"]


def test_parents_requests_and_counters_land_on_the_innermost_span():
    trace.enable()
    with trace.span("ivc.outer"):
        trace.count("h2d_bytes", 5)
        with trace.span("ivc.mid"):
            with trace.span("ivc.inner"):
                trace.count("syncs")
                trace.count("syncs", 2)
            trace.count("d2h_bytes", 7)
    with trace.span("ivc.next"):
        pass
    trace.count("syncs")  # outside any span: the totals only
    first, second = trace.requests()
    assert first["name"] == "ivc.outer" and second["name"] == "ivc.next"
    spans = {s["name"]: s for s in first["spans"]}
    assert spans["ivc.outer"]["parent"] is None
    assert spans["ivc.mid"]["parent"] == spans["ivc.outer"]["id"]
    assert spans["ivc.inner"]["parent"] == spans["ivc.mid"]["id"]
    assert first["id"] == spans["ivc.outer"]["id"] != second["id"]
    assert spans["ivc.inner"]["counts"] == {"syncs": 3}
    assert spans["ivc.mid"]["counts"] == {"d2h_bytes": 7}
    assert spans["ivc.outer"]["counts"] == {"h2d_bytes": 5}
    for s in first["spans"]:
        assert s["t0_ns"] <= s["t1_ns"] and s["device_ms"] is None
    assert spans["ivc.outer"]["t0_ns"] <= spans["ivc.mid"]["t0_ns"]
    assert spans["ivc.mid"]["t1_ns"] <= spans["ivc.outer"]["t1_ns"]
    rep = trace.summary()
    assert rep["counts"] == {"h2d_bytes": 5, "syncs": 4, "d2h_bytes": 7}
    assert rep["names"]["ivc.inner"]["calls"] == 1 and rep["dropped"] == 0


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 2)
    trace.enable()
    for _ in range(3):
        with trace.span("ivc.a"):
            pass
    rep = trace.summary()
    assert len(trace.requests()) == 2 and rep["dropped"] == 1
    assert rep["names"]["ivc.a"]["calls"] == 3


def test_threads_keep_their_own_parents_and_lose_no_count():
    """More threads than cores, switching often: every span and count is
    kept, and each thread's spans nest under its own outer span."""
    trace.enable()
    n_threads, n_spans = 32, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            with trace.span("ivc.outer"):
                for _ in range(n_spans):
                    with trace.span("ivc.inner"):
                        trace.count("syncs")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    rep = trace.summary()
    assert rep["counts"] == {"syncs": n_threads * n_spans}
    assert rep["names"]["ivc.inner"]["calls"] == n_threads * n_spans
    requests = trace.requests()
    assert len(requests) == n_threads
    for r in requests:
        assert len(r["spans"]) == n_spans + 1
        assert {s["parent"] for s in r["spans"][1:]} == {r["id"]}


def test_spans_are_user_annotations_nested_on_the_recorders_clock(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(6):
            with trace.span("ivc.outer"):
                torch.ones(256).cumsum(0)
                with trace.span("ivc.inner"):
                    torch.ones(64) * i
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc["baseTimeNanoseconds"] / 1e3
    events = sorted((e for e in doc["traceEvents"]
                     if e.get("ph") == "X" and e.get("name", "").startswith("ivc.")),
                    key=lambda e: e["ts"])
    assert {e["cat"] for e in events} == {"user_annotation"}
    outer = [e for e in events if e["name"] == "ivc.outer"]
    inner = [e for e in events if e["name"] == "ivc.inner"]
    assert len(outer) == len(inner) == 6
    for o, n in zip(outer, inner):  # nested as recorded
        assert o["ts"] <= n["ts"] and n["ts"] + n["dur"] <= o["ts"] + o["dur"]
    recorded = sorted((s for r in trace.requests() for s in r["spans"]),
                      key=lambda s: s["t0_ns"])
    assert [s["name"] for s in recorded] == [e["name"] for e in events]
    gaps = [abs(s["t0_ns"] / 1e3 - base_us - e["ts"]) for s, e in zip(recorded, events)]
    assert max(gaps[1:]) <= 100, gaps  # the trace's first span pays the profiler's warm-up


H, W, T = 64, 128, 8


@pytest.fixture(scope="module")
def gop():
    y = fixtures.video("foreman", num_frames=T).astype(np.float32).mean(-1)
    return torch.from_numpy(np.ascontiguousarray(y[:, :H, :W]))


def _fused_roundtrip(codec, frames):
    qsyms, mvs, _, _ = codec.encode_gop(frames)
    p = codec.pack_gop(qsyms, check=False)
    recons, ok = codec.decode_gop(p.words, p.offsets, p.counts, mvs, H, W, p.block_words, p.cap)
    return [qsyms, mvs, p.words, p.offsets, p.counts, p.totals, recons, ok & p.ok]


def _cells(frames):
    """The calls of the benchmark's three cells on the CPU: each a function
    of nothing returning what it produced, and the span tree of each of its
    requests."""
    fused = FusedVideoCodec(device="cpu")
    fused.train(frames[:2])
    fused.pack_gop(fused.encode_gop(frames)[0])  # settles the sticky buckets
    adaptive = VideoCodec(1.0, codebook_policy="per-frame", device="cpu")
    blob = adaptive.encode_to_container(frames)
    decode = ("ivc.adaptive.decode", [(n, []) for n in (
        "ivc.decode.parse", "ivc.decode.tables", "ivc.decode.upload", "ivc.decode.enqueue")])
    pack = ("ivc.fused.pack_gop", [("ivc.pack.map", []), ("ivc.pack.deposit", [])])
    limits = [("ivc.codebook.limit", [])] * T
    encode = ("ivc.adaptive.encode", [
        ("ivc.adaptive.scan", []), ("ivc.fetch", []), ("ivc.adaptive.codebooks", limits),
        ("ivc.adaptive.pack", [("ivc.fetch", [])] * 3), ("ivc.adaptive.serialize", [])])

    def stream():
        out = adaptive.encode_to_container(frames)
        return [out, *VideoCodec.decode_from_container(out, return_device=True, device="cpu")]

    return {
        "fused_1080p.stream": (lambda: _fused_roundtrip(fused, frames),
                               [[("ivc.fused.encode_gop", [])], [pack],
                                [("ivc.fused.decode_gop", [])]]),
        "adaptive_1080p.stream": (stream, [[encode], [decode]]),
        "adaptive_1080p.decode": (
            lambda: list(VideoCodec.decode_from_container(blob, return_device=True,
                                                          device="cpu")),
            [[decode]]),
    }


@pytest.mark.parametrize("cell", ["fused_1080p.stream", "adaptive_1080p.stream",
                                  "adaptive_1080p.decode"])
def test_a_cells_calls_emit_their_span_trees_and_the_same_outputs(gop, cell):
    call, trees = _cells(gop)[cell]
    off = call()
    assert trace.requests() == []
    trace.enable()
    on = call()
    requests = trace.requests()
    trace.disable()
    assert [_tree(r) for r in requests] == trees
    assert sum(len(r["spans"]) for r in requests) <= 100  # a GOP's spans
    assert len(off) == len(on)
    for a, b in zip(off, on):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_the_fused_container_decode_has_the_decodes_four_phases(gop):
    codec = FusedVideoCodec(device="cpu")
    codec.train(gop[:2])
    blob = codec.encode_to_container(gop)
    trace.enable()
    FusedVideoCodec.decode_from_container(blob, device="cpu")
    (req,) = trace.requests()
    ((name, kids),) = _tree(req)
    assert name == "ivc.fused.decode_from_container"
    assert [k for k, _ in kids] == ["ivc.decode.parse", "ivc.decode.tables",
                                    "ivc.decode.upload", "ivc.decode.enqueue"]
    assert [k for k, _ in kids[3][1]] == ["ivc.fused.decode_gop"]


@pytest.mark.cuda
def test_the_syncs_counter_equals_host_syncs_on_the_card(cuda_device):
    from ivclab_tpu_torch.utils.timing import host_syncs

    y = fixtures.video("foreman", num_frames=T, shape=(128, 256)).astype(np.float32).mean(-1)
    frames = torch.from_numpy(np.ascontiguousarray(y)).to(cuda_device)
    adaptive = VideoCodec(1.0, codebook_policy="per-frame", device=cuda_device)
    blob = adaptive.encode_to_container(frames)  # builds the kernels
    fused = FusedVideoCodec(device=cuda_device)
    fused.train(frames[:2])
    fused.pack_gop(fused.encode_gop(frames)[0])

    def roundtrip():
        qsyms, mvs, _, _ = fused.encode_gop(frames)
        p = fused.pack_gop(qsyms, check=False)
        return fused.decode_gop(p.words, p.offsets, p.counts, mvs, 128, 256, p.block_words,
                                p.cap)

    VideoCodec.decode_from_container(blob, return_device=True, device=cuda_device)
    roundtrip()
    calls = {
        "encode_to_container": lambda: adaptive.encode_to_container(frames),
        "decode_from_container": lambda: VideoCodec.decode_from_container(
            blob, return_device=True, device=cuda_device),
        "fused round trip": roundtrip,
    }
    for name, fn in calls.items():
        trace.enable()
        found = sum(n for _, n in host_syncs(fn))
        counted = trace.summary()["counts"].get("syncs", 0)
        trace.disable()
        assert counted == found, (name, counted, found)
        if name == "encode_to_container":
            assert found >= 3
        else:
            assert found == 0, name
    assert host_syncs(roundtrip) == []  # the recorder off
    trace.enable()
    roundtrip()
    torch.cuda.synchronize()
    spans = [s for r in trace.requests() for s in r["spans"]]
    for name in ("ivc.pack.map", "ivc.pack.deposit"):
        (ms,) = [s["device_ms"] for s in spans if s["name"] == name]
        assert ms is not None and ms > 0, name
