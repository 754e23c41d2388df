"""The readers of the port's own spans and counters (``program_spans.py``
and the eight ``metrics/<name>.py`` that use it) give known answers on a
canned recorder, keep the first ``n_traced`` requests of each outermost
call, and read nothing where the run traced nothing or the port records
nothing."""

import pytest

from codec_bench import harness
from codec_bench.program_spans import kept
from codec_bench.tests.tiny import ROOT
from ivclab_tpu_torch.runtime import trace

MANIFEST = ROOT / "BENCHMARK.json"
NEW = ("pack_map_dev_ms", "pack_deposit_dev_ms", "codebook_host_ms", "host_fetch_ms",
       "decode_prep_ms", "decode_enqueue_ms", "host_syncs_per_gop", "copy_kib_per_gop")
SLICE = {"window": (0.0, 1.0), "ops": [], "calls": []}


def _request(rid: int, name: str, host_ms: float, children=()) -> dict:
    """A request as ``trace.requests()`` gives it: its outermost span, then
    ``children``, each ``(name, host ms, device ms, counts)``, all children
    of the outermost span."""
    spans = [{"name": name, "id": rid, "parent": None, "t0_ns": rid * 10**9,
              "t1_ns": rid * 10**9 + int(host_ms * 1e6), "host_ms": host_ms,
              "device_ms": None, "counts": {}}]
    for k, (n, ms, dev, counts) in enumerate(children, 1):
        spans.append({"name": n, "id": rid + k, "parent": rid, "t0_ns": rid * 10**9 + k,
                      "t1_ns": rid * 10**9 + k + int(ms * 1e6), "host_ms": ms,
                      "device_ms": dev, "counts": counts})
    return {"id": rid, "name": name, "spans": spans}


def _fused(gops: int) -> list[dict]:
    """``gops`` GOPs of the fused round trip; GOP g's pack map takes 1 + g
    device ms, its deposit 10 + g."""
    out = []
    for g in range(gops):
        rid = 100 * (g + 1)
        out += [_request(rid, "ivc.fused.encode_gop", 3.0),
                _request(rid + 10, "ivc.fused.pack_gop", 2.0, [
                    ("ivc.pack.map", 0.5, 1.0 + g, {}),
                    ("ivc.pack.deposit", 0.5, 10.0 + g, {})]),
                _request(rid + 20, "ivc.fused.decode_gop", 1.0)]
    return out


def _adaptive(gops: int) -> list[dict]:
    """``gops`` GOPs of the adaptive stream: an encode whose codebooks take
    40 + g host ms, two fetches of 2 ms (one sync and 1,024 bytes each), and
    a decode of 1 + 2 + 3 ms preparation (uploading 2,048 bytes) and 20 ms
    enqueue."""
    out = []
    fetch = ("ivc.fetch", 2.0, None, {"syncs": 1, "d2h_bytes": 1024})
    for g in range(gops):
        rid = 100 * (g + 1)
        out += [_request(rid, "ivc.adaptive.encode", 60.0, [
                    ("ivc.adaptive.scan", 5.0, None, {}), fetch,
                    ("ivc.adaptive.codebooks", 40.0 + g, None, {}), fetch]),
                _request(rid + 50, "ivc.adaptive.decode", 26.5, [
                    ("ivc.decode.parse", 1.0, None, {}),
                    ("ivc.decode.tables", 2.0, None, {"h2d_bytes": 1024}),
                    ("ivc.decode.upload", 3.0, None, {"h2d_bytes": 1024}),
                    ("ivc.decode.enqueue", 20.0, None, {})])]
    return out


def _ctx(cell: str, canned, monkeypatch, n_traced: int = 2, sl=SLICE):
    monkeypatch.setattr(trace, "requests", lambda: canned)
    c = harness.Cell(MANIFEST, cell)
    return harness.Context(c, sl, n_traced, [], {}, 4), c


def test_fused_stream_known_answers(monkeypatch):
    # a third GOP was dispatched while the profiler still recorded: left out
    ctx, cell = _ctx("fused_1080p.stream", _fused(3), monkeypatch)
    assert cell.reader("pack_map_dev_ms")(ctx) == pytest.approx((1 + 2) / 2)
    assert cell.reader("pack_deposit_dev_ms")(ctx) == pytest.approx((10 + 11) / 2)
    assert cell.reader("host_syncs_per_gop")(ctx) == 0  # never touched: 0, not None
    assert cell.reader("copy_kib_per_gop")(ctx) == 0
    assert cell.reader("codebook_host_ms")(ctx) is None  # no such span


def test_adaptive_stream_known_answers(monkeypatch):
    ctx, cell = _ctx("adaptive_1080p.stream", _adaptive(3), monkeypatch)
    assert cell.reader("codebook_host_ms")(ctx) == pytest.approx((40 + 41) / 2)
    assert cell.reader("host_fetch_ms")(ctx) == pytest.approx(4.0)
    assert cell.reader("decode_prep_ms")(ctx) == pytest.approx(6.0)
    assert cell.reader("decode_enqueue_ms")(ctx) == pytest.approx(20.0)
    assert cell.reader("host_syncs_per_gop")(ctx) == pytest.approx(2.0)
    assert cell.reader("copy_kib_per_gop")(ctx) == pytest.approx(4.0)
    assert cell.reader("pack_map_dev_ms")(ctx) is None


def test_the_first_n_traced_requests_of_each_outermost_call(monkeypatch):
    canned = _adaptive(4)
    ctx, _ = _ctx("adaptive_1080p.stream", canned, monkeypatch, n_traced=3)
    got = kept(ctx)
    assert [r["id"] for r in got] == [100, 150, 200, 250, 300, 350]
    # interleaved differently, the rule still counts each call on its own
    encodes = [r for r in canned if r["name"] == "ivc.adaptive.encode"]
    decodes = [r for r in canned if r["name"] == "ivc.adaptive.decode"]
    ctx, _ = _ctx("adaptive_1080p.stream", encodes + decodes, monkeypatch, n_traced=3)
    assert [r["id"] for r in kept(ctx)] == [100, 200, 300, 150, 250, 350]


def test_a_span_without_device_time_reads_nothing(monkeypatch):
    canned = _fused(2)
    canned[1]["spans"][1]["device_ms"] = None  # its events never ran
    ctx, cell = _ctx("fused_1080p.stream", canned, monkeypatch)
    assert cell.reader("pack_map_dev_ms")(ctx) is None
    assert cell.reader("pack_deposit_dev_ms")(ctx) == pytest.approx(10.5)


@pytest.mark.parametrize("n_traced,sl", [(0, SLICE), (2, None)])
def test_nothing_traced_reads_nothing_whatever_the_recorder_holds(monkeypatch, n_traced, sl):
    ctx, cell = _ctx("adaptive_1080p.stream", _adaptive(3), monkeypatch, n_traced, sl)
    for name in NEW:
        assert cell.reader(name)(ctx) is None, name


@pytest.mark.parametrize("canned", [[], None])
def test_a_port_that_records_nothing_reads_nothing(monkeypatch, canned):
    """An empty recorder, or a port without one (the recorder's reader
    missing): every new metric is left out of the line, and none raises."""
    ctx, cell = _ctx("adaptive_1080p.stream", canned, monkeypatch)
    if canned is None:
        monkeypatch.delattr(trace, "requests")
    for name in NEW:
        assert cell.reader(name)(ctx) is None, name
