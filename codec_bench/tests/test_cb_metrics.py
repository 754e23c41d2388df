"""The per-layer metrics' readers give known answers on a canned trace."""

import json

import numpy as np
import pytest

from codec_bench import harness, roofline, trace
from codec_bench.tests.tiny import ROOT

MANIFEST = ROOT / "BENCHMARK.json"


def _events():
    """Two GOPs of 400 us in a 1,000 us slice: a copy launched outside any
    call, an ``me_kernel`` launched in GOP 0's pack call and a walk launched
    in GOP 1's, plus an op of a third, untraced GOP."""
    X = lambda cat, name, ts, dur, **args: {"ph": "X", "cat": cat, "name": name, "ts": ts,
                                            "dur": dur, "args": args}
    return [
        X("user_annotation", "cb.slice", 0, 1000),
        X("user_annotation", "cb.gop/0", 0, 400),
        X("user_annotation", "cb.gop/1", 400, 400),
        X("user_annotation", "cb.gop/2", 800, 150),
        X("user_annotation", "cb.pack_gop", 100, 100),
        X("user_annotation", "cb.pack_gop", 500, 100),
        X("cuda_runtime", "cudaMemcpyAsync", 50, 2, correlation=3),
        X("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=1),
        X("cuda_driver", "cuLaunchKernelEx", 550, 5, correlation=2),
        X("cuda_runtime", "cudaLaunchKernel", 850, 5, correlation=4),
        X("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 60, 40, correlation=3),
        X("kernel", "void (anonymous namespace)::me_kernel<4>(float const*, int*)", 300, 100,
          correlation=1),
        X("kernel", "_ZN12_GLOBAL__N_111walk_kernelILi64EEEvPKlPKiS4_", 700, 50, correlation=2),
        X("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 900, 30, correlation=4),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 150, "id": 1},
    ]


@pytest.fixture
def ctx():
    sl = trace.read_events(_events())
    cell = harness.Cell(MANIFEST, "fused_1080p.stream")
    bits = np.full(64, 100)
    walks = {1: [{"kind": "hot", "block_bits": bits, "LW": 8, "max_syms": 32}]}
    host = [{"cb.encode_gop": 1.0, "cb.pack_gop": 2.0, "cb.decode_gop": 3.0},
            {"cb.encode_gop": 2.0, "cb.pack_gop": 2.0, "cb.decode_gop": 4.0}]
    return harness.Context(cell, sl, 2, host, walks, 4), cell


def _read(cell, name, c):
    return cell.reader(name)(c)


def test_attribution(ctx):
    c, _ = ctx
    ops = c.ops()
    assert [(o["name"], o["gop"], o["call"]) for o in ops] == [
        ("HtoD", 0, None), ("me_kernel", 0, "cb.pack_gop"),
        ("walk_kernel", 1, "cb.pack_gop")]
    assert c.launches("walk_kernel") == [(1, 0, 50.0)]


def test_readers_known_answers(ctx):
    c, cell = ctx
    assert _read(cell, "device_idle_pct", c) == pytest.approx(100 * (1 - 220 / 1000))
    assert _read(cell, "launches_per_gop", c) == pytest.approx(1.5)
    assert _read(cell, "pack_dev_ms", c) == pytest.approx(0.075)
    assert _read(cell, "dispatch_ms", c) == pytest.approx(7.0)
    assert _read(cell, "decode_dev_ms", c) is None  # no op launched inside a decode
    me = roofline.motion_search_bound(1088, 1088, 1920, 4)[0]
    assert _read(cell, "me_roofline_pct", c) == pytest.approx(100 * me / 0.1)
    walk = roofline.decode_walk_bound(np.full(64, 100), 8, 32)[0]
    assert _read(cell, "hot_walk_roofline_pct", c) == pytest.approx(100 * walk / 0.05)
    assert _read(cell, "adaptive_encode_ms", c) is None
    assert _read(cell, "adaptive_decode_ms", c) is None


def test_a_reader_with_nothing_to_read_returns_nothing():
    cell = harness.Cell(MANIFEST, "adaptive_1080p.decode")
    empty = harness.Context(cell, None, 0, [], {}, 4)
    for m in json.loads(MANIFEST.read_text())["per_layer"]:
        assert cell.reader(m["name"])(empty) is None, m["name"]


def test_breakdown(ctx):
    b = trace.breakdown(trace.read_events(_events()))
    assert [n for n, _ in b["device_ops"]][:2] == ["me_kernel", "walk_kernel"]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx((1000 - 220) * 1e-6)
