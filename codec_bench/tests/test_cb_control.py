"""The lower-precision control fails the check: the reference one precision
below the configuration's (TF32 transforms, bfloat16 search) in the
program's place comes out not correct in every cell, and so does the
stale-codebook fault, at a size a test run holds (the CPU, 64x128)."""

import json

import pytest

from codec_bench import harness
from codec_bench.calibrate import control_numbers
from codec_bench.tests.tiny import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny, cell, seed):
    limits = harness.Cell(tiny, cell).limits
    nums = control_numbers(tiny, cell, seed, "cpu", "control")
    assert any(nums[k] > limits[k] for k in limits), nums


@pytest.mark.parametrize("kind,number", [("encoder", "me_gap"), ("encoder", "quant_excess"),
                                         ("stale_code", "rate_gap")])
@pytest.mark.parametrize("cell", CELLS)
def test_each_number_has_a_reading_above_its_limit(tiny, cell, kind, number):
    limits = harness.Cell(tiny, cell).limits
    nums = control_numbers(tiny, cell, 2**31 + 4, "cpu", kind)
    assert nums[number] > limits[number], nums


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_on_the_card_is_correct(tiny, cuda_device, cell):
    r = harness.run(tiny, cell, 2**31 + 17, 1.0, False, device=cuda_device, log=lambda s: None)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
