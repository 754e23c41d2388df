"""The manifest keeps to the benchmark's contract, and every cell's files
resolve by name; a configuration, a mix and a metric are each added as files
of their own without editing any file that is there."""

import json
import re
import shutil

import pytest

from codec_bench import checks, harness
from codec_bench.tests.tiny import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["codec_bench"]
    assert MANIFEST["command"][1] == "codec_bench/run.py"
    assert 1 <= MANIFEST["run_seconds"] <= 51
    n = len(MANIFEST["workloads"])
    assert 1 <= n <= 24 and 1 <= len(MANIFEST["configs"]) <= 24
    # the check's budget with the full 24 cells
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert c["file"].startswith("codec_bench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert "setup_s" in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    """Each cell's files load, and its limits name exactly the numbers its
    judge reads: the judge's ``NUMBERS``, or the four video numbers of a
    luma GOP codec's judge."""
    c = harness.Cell(ROOT / "BENCHMARK.json", cell)
    keys = {"codec", "H", "W", "q", "source", "assumed", "reduced"}
    if hasattr(c.judge, "NUMBERS"):
        assert callable(c.judge.numbers) and callable(c.judge.control)
        assert set(c.limits) == set(c.judge.NUMBERS)
    else:
        keys |= {"T", "sr"}
        assert callable(c.judge.parse) and callable(c.judge.rates)
        assert set(c.limits) == set(checks.VIDEO)
    assert keys <= set(c.cfg)
    assert callable(c.program) and callable(c.input.make)
    assert callable(c.loop.build) and isinstance(c.loop.CONTAINERS, bool)
    assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer
    for name, path in c.metric_files.items():
        assert callable(c.reader(name)), path


def test_a_new_config_mix_and_metric_are_files_of_their_own(tiny, tmp_path):
    """Add a configuration (sr 2) naming a codec of its own, a mix (depth
    1) with a loop of its own and a metric, by adding files and entries
    only, then run the new cell on the CPU."""
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    root = tiny.parent
    bench = root / "codec_bench"
    cfg = json.loads((bench / "configs/fused_1080p.json").read_text())
    cfg.update(sr=2, codec="DummyCodec")
    (bench / "configs/dummy_sr2.json").write_text(json.dumps(cfg))
    # a codec of its own: the program's calls and the reference's side
    shutil.copytree(bench / "codec/FusedVideoCodec", bench / "codec/DummyCodec")
    # a loop of its own: each step encodes its GOP to a container and
    # decodes that back
    (bench / "loops/container_trip.py").write_text(
        "CONTAINERS = False\n\n\ndef build(prog, gops):\n"
        "    def step(i):\n"
        "        blob = prog.encode(gops[i % len(gops)])\n"
        "        out, ok, info = prog.decode(blob)\n"
        "        return dict(out, blob=blob), ok, info\n"
        "    return step, None\n")
    mix = json.loads((bench / "traffic/stream.json").read_text())
    mix.update(depth=1, loop="container_trip")
    (bench / "traffic/serial.json").write_text(json.dumps(mix))
    shutil.copy(bench / "limits/fused_1080p.stream.json", bench / "limits/dummy_sr2.serial.json")
    (bench / "metrics/dummy_count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.host_ms)) or None\n")
    m = json.loads(tiny.read_text())
    m["configs"].append({"name": "dummy_sr2", "source": "https://example.org/dummy",
                         "file": "codec_bench/configs/dummy_sr2.json", "reduced": ["sr"],
                         "why": "a dummy"})
    m["workloads"].append({"name": "dummy_sr2.serial", "config": "dummy_sr2",
                           "traffic": "serial", "chips": 1, "why": "a dummy"})
    m["per_layer"].append({"name": "dummy_count", "unit": "GOPs", "better": "higher",
                           "source": "program_span", "layer": "Test", "moves": "p95_ms",
                           "workloads": ["dummy_sr2.serial"]})
    tiny.write_text(json.dumps(m))
    for p, b in before.items():
        if p != tiny:
            assert p.read_bytes() == b, p
    cell = harness.Cell(tiny, "dummy_sr2.serial")
    assert cell.cfg["sr"] == 2 and cell.traffic["depth"] == 1
    assert cell.loop.__file__.endswith("container_trip.py")
    assert "DummyCodec" in cell.judge.__file__
    assert [x["name"] for x in cell.per_layer] == ["dummy_count"]
    r = harness.run(tiny, "dummy_sr2.serial", 3, 4.0, False, device="cpu", log=lambda s: None)
    assert r["attempted"] >= 1 and r["failed"] == 0
    c = r["checks"]
    assert all(c[k]["value"] <= c[k]["limit"] for k in ("me_gap", "quant_excess", "recon_gap"))
    # a 64x128 training clip: a few symbols rounded apart move its codebook
    assert c["rate_gap"]["value"] < 0.01


@pytest.mark.parametrize("key,value", [("loop", "nonesuch"), ("codec", "NoSuchCodec"),
                                       ("input", "no_such_input")])
def test_a_name_with_no_file_is_refused(tiny, key, value):
    """A mix naming a loop, or a configuration naming a codec or an input
    kind, that has no file stops the run before set-up: nothing falls
    through to another."""
    bench = tiny.parent / "codec_bench"
    path = bench / ("traffic/stream.json" if key == "loop" else "configs/fused_1080p.json")
    data = json.loads(path.read_text())
    data[key] = value
    path.write_text(json.dumps(data))
    with pytest.raises(FileNotFoundError, match=value):
        harness.Cell(tiny, "fused_1080p.stream")
