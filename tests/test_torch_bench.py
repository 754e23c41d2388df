"""``ivclab_tpu_torch/tools/bench.py`` against the repository's ``bench.py``.

The JAX ``bench.py`` runs once for the module in a subprocess on the CPU
(its own compile cache in a temporary directory, 300 s limit) at 128x256,
4 frames, a 3-GOP stream, one loop of one round trip; the twin runs at the
same knobs with ``device="cpu"``. Their lines must have the same keys, the
same metric string and counts, the same mean bpp and adaptive container
bytes, and PSNR-Y equal to its printed 0.01 dB. Times are the CPU's and
are not compared; each line's stage sum and ``vs_baseline`` must agree
with its own numbers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)

from ivclab_tpu_torch.tools import bench

REPO = Path(__file__).resolve().parents[1]
KNOBS = {"IVC_BENCH_H": "128", "IVC_BENCH_W": "256", "IVC_BENCH_FRAMES": "4",
         "IVC_BENCH_ITERS": "1", "IVC_BENCH_REPEATS": "1", "IVC_BENCH_SUSTAINED": "3"}
H, W, T = 128, 256, 4


@pytest.fixture(scope="module")
def jax_line(tmp_path_factory):
    env = {**os.environ, **KNOBS, "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(tmp_path_factory.mktemp("jax_cache"))}
    out = subprocess.run([sys.executable, str(REPO / "bench.py")], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_line():
    return bench.run(device="cpu", H=H, W=W, T=T, iters=1, repeats=1, sustained=3)


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_line_has_the_jax_keys_and_metric(jax_line, port_line):
    assert _keys(port_line) == _keys(jax_line)
    assert port_line["metric"] == jax_line["metric"]
    assert port_line["unit"] == "Mpix/s"
    assert port_line["detail"]["backend"] == "cpu" == jax_line["detail"]["backend"]


def test_counts_bits_and_bytes_equal_jax(jax_line, port_line):
    p, j = port_line["detail"], jax_line["detail"]
    for key in ("frames", "sustained_gops", "mean_bpp"):
        assert p[key] == j[key], key
    assert len(p["repeats_mpix_per_s"]) == len(j["repeats_mpix_per_s"])
    assert p["adaptive_1080p"]["container_bytes"] == j["adaptive_1080p"]["container_bytes"]


def test_psnr_equals_jax_to_the_printed_digit(jax_line, port_line):
    p, j = port_line["detail"], jax_line["detail"]
    assert abs(p["psnr_y_db"] - j["psnr_y_db"]) <= 0.01 + 1e-9
    assert abs(p["adaptive_1080p"]["psnr_y_db"] - j["adaptive_1080p"]["psnr_y_db"]) <= 0.01 + 1e-9
    assert p["psnr_y_db"] > 28.0


@pytest.mark.parametrize("which", ["port", "jax"])
def test_line_agrees_with_itself(which, jax_line, port_line):
    """The stage sum is the sum of the stages and vs_baseline the headline
    over real time (30 fps), each within its rounding."""
    line = port_line if which == "port" else jax_line
    d = line["detail"]
    stages = d["stages_ms_per_gop_amortized"]
    assert set(stages) == {"encode", "pack", "decode"}
    assert abs(d["stage_sum_ms"] - sum(stages.values())) <= 0.05 * len(stages) + 0.05 + 1e-9
    base = H * W * 30 / 1e6
    assert abs(line["vs_baseline"] - line["value"] / base) <= 0.0005 + 0.005 / base + 1e-9
    assert line["value"] == d["sustained_mpix_per_s"] > 0
    assert d["repeats_mpix_per_s"] == sorted(d["repeats_mpix_per_s"])
    gaps = d["gop_gap_ms"]
    assert gaps["min"] <= gaps["median"] <= gaps["max"]


def test_main_reads_the_knobs_and_prints_one_line(monkeypatch, capsys, tmp_path):
    """main() takes bench.py's environment knobs: 3 frames, no adaptive half,
    a trace, and a stream of 8 GOPs capped at 6 on the CPU."""
    for k, v in {**KNOBS, "IVC_BENCH_FRAMES": "3", "IVC_BENCH_SUSTAINED": "8",
                 "IVC_BENCH_ADAPTIVE": "0", "IVC_BENCH_TRACE": str(tmp_path)}.items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == ("encode+decode 256x128 hybrid video sustained throughput "
                              "(1 chip, q=1.0, 6-GOP stream)")
    d = line["detail"]
    assert d["frames"] == 3 and d["sustained_gops"] == bench.CPU_MAX_GOPS == 6
    assert "adaptive_1080p" not in d
    assert (tmp_path / "trace.json").is_file()


def test_default_device_is_the_card():
    """run() defaults to cuda: without a card it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        bench.run(H=H, W=W, T=T, iters=1, repeats=1, sustained=1)
