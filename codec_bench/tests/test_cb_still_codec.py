"""A configuration that is not a luma GOP codec joins the benchmark by new
files and manifest entries alone: a still-image codec that exists only in
these tests (``still_codec/``: RGB images, three 4:4:4 planes under two
quantiser tables, a judge that owns its numbers and its control) reads
the ``rgb_still`` input through a depth-1 mix, and runs through the
harness on the CPU; a planted fault, and its control, read above their
limits."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from codec_bench import harness
from codec_bench.calibrate import control_numbers
from codec_bench.tests.tiny import BENCH, TINY

STILL = Path(__file__).resolve().parent / "still_codec"
CELL = "still_test.request"
LIMITS = {"quant_excess": 2e-4, "recon_gap": 2e-3, "rate_gap": 1e-3}
FAULTS = {
    # one symbol off by one where the encoder produces it
    "symbol_off_by_one": ("            totals = ",
                          "            qsyms[0, 5, 0] += 1\n            totals = "),
    # Cb and Cr dequantised with the luminance table
    "chroma_through_luma_table": ("zip(self.tables, blocks)", "zip(self.tables[:1] * 3, blocks)"),
}

def _add_still_codec(tiny: Path, fault: str | None = None) -> None:
    """Add the still-image configuration, its codec, mix, limits and cell
    to the tiny checkout as new files and entries."""
    bench = tiny.parent / "codec_bench"
    codec = bench / "codec" / "StillTestCodec"
    codec.mkdir()
    src = (STILL / "program.py").read_text()
    if fault:
        old, new = FAULTS[fault]
        assert old in src
        src = src.replace(old, new)
    (codec / "program.py").write_text(src)
    shutil.copy(STILL / "judge.py", codec / "judge.py")
    cfg = {"codec": "StillTestCodec", "input": "rgb_still", "q": 1.0,
           "precision": "float32 with TF32 off", "source": "a codec of the tests",
           "assumed": [], "reduced": [], **TINY}
    (bench / "configs" / "still_test.json").write_text(json.dumps(cfg))
    mix = {"loop": "roundtrip", "clip_gops": 4, "depth": 1, "warm_cycles": 1,
           "trace_gops": 2, "check_gops": 2, "check_within": 4}
    (bench / "traffic" / "request.json").write_text(json.dumps(mix))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    m = json.loads(tiny.read_text())
    m["configs"].append({"name": "still_test", "source": "https://example.org/still",
                         "file": "codec_bench/configs/still_test.json", "reduced": [],
                         "why": "a still-image codec of the tests"})
    m["workloads"].append({"name": CELL, "config": "still_test", "traffic": "request",
                           "chips": 1, "why": "a still-image codec of the tests"})
    tiny.write_text(json.dumps(m))


def _run(tiny):
    return harness.run(tiny, CELL, 2**31 + 7, 1.0, False, device="cpu", log=lambda s: None)


def test_a_still_image_codec_is_files_of_its_own_and_correct(tiny, tmp_path):
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    _add_still_codec(tiny)
    for p, b in before.items():
        if p != tiny:
            assert p.read_bytes() == b, p
    cell = harness.Cell(tiny, CELL)
    assert cell.input.__file__.endswith("rgb_still.py") and cell.traffic["depth"] == 1
    assert set(cell.limits) == set(cell.judge.NUMBERS)
    r = _run(tiny)
    assert r["correct"] and r["attempted"] >= 4 and r["failed"] == 0, r["checks"]
    assert set(r["checks"]) == set(LIMITS) | {"failed_gops"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_still_codec_is_not_correct(tiny, fault):
    _add_still_codec(tiny, fault)
    r = _run(tiny)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("kind,number", [("control", "quant_excess"),
                                         ("stale_code", "rate_gap")])
def test_the_still_codecs_controls_read_above_their_limits(tiny, kind, number):
    _add_still_codec(tiny)
    for seed in (2**31 + 1, 2**31 + 2):
        nums = control_numbers(tiny, CELL, seed, "cpu", kind)
        assert nums[number] > LIMITS[number], nums


def test_rgb_still_is_a_function_of_the_seed_with_one_card():
    mod = harness.load(BENCH / "inputs" / "rgb_still.py", "input_rgb_still")
    cfg = dict(TINY)
    a, units = mod.make(2**31 + 11, cfg, 3, "cpu")
    b, _ = mod.make(2**31 + 11, cfg, 3, "cpu")
    c, _ = mod.make(12, cfg, 3, "cpu")
    assert a.shape == (3, 64, 128, 3) and len(units) == 3 and torch.equal(units[1], a[1])
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, a.round()) and a.min() >= 0 and a.max() <= 255
    ch, cw = 64 // 4, 128 // 4
    card = a[0, :ch, :cw]
    assert all(torch.equal(img[:ch, :cw], card) for img in torch.cat([a, c]))
    assert (a[:, ch:] != c[:, ch:]).float().mean() > 0.5
    # the chroma follows the luma but is not the luma
    x = a.reshape(-1, 3).to(torch.float64)
    r = torch.corrcoef(x.T)
    assert 0.3 < float(r[0, 2]) < 0.99 and 0.3 < float(r[1, 2]) < 0.99
