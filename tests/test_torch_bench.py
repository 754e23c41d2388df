"""``ivclab_tpu_torch/tools/bench.py`` against the repository's ``bench.py``.

The JAX ``bench.py`` runs once for the module in a subprocess on the CPU
(its own compile cache in a temporary directory, 300 s limit) at 128x256,
4 frames, a 3-GOP stream, one loop of one round trip; the twin runs at the
same knobs with ``device="cpu"``. Their lines must have the same keys, the
same metric string and counts, the same mean bpp and adaptive container
bytes, and PSNR-Y equal to its printed 0.01 dB. Times are the CPU's and
are not compared; each line's stage sum and ``vs_baseline`` must agree
with its own numbers. A warm round trip reads nothing back to the host
but the plain decode walk's bound, which the card's kernel does without.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

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


HOST_READS = {"__int__", "__bool__", "__float__", "__index__", "item", "tolist", "cpu", "numpy"}


def _package_frame() -> str:
    """The innermost function of ``ivclab_tpu_torch`` on the stack."""
    for frame in reversed(traceback.extract_stack()[:-2]):
        if f"{os.sep}ivclab_tpu_torch{os.sep}" in frame.filename:
            return frame.name
    return "<outside the package>"


class _HostReads(TorchFunctionMode):
    """Records every read of a tensor's value by the host and every copy of
    host data into a tensor, each with the function it was made in."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if (name in HOST_READS
                or (func is torch.as_tensor and args and isinstance(args[0], np.ndarray))
                or (name == "__setitem__" and len(args) == 3
                    and isinstance(args[2], (bool, int, float)))):
            self.reads.append((name, _package_frame()))
        return func(*args, **(kwargs or {}))


def test_warm_roundtrip_reads_back_only_the_plain_walk_bound(monkeypatch):
    """One warm encode -> pack(check=False) -> decode on the CPU at 128x256:
    the only host read left is ``int(counts.max())`` in
    ``decode_blocks_hot_plain``, the loop bound that the card's walk kernel
    does not need. (On the card such reads are syncs: the MV length table
    copied up on each call and ``map_codes_hot``'s scalar store were two.)"""
    run = bench.measure(device="cpu", H=H, W=W, T=T, iters=1, repeats=1, sustained=1,
                        adaptive=False)
    run.roundtrip()
    with _HostReads() as rec:
        real = torch.from_numpy

        def from_numpy(a):
            rec.reads.append(("from_numpy", _package_frame()))
            return real(a)

        monkeypatch.setattr(torch, "from_numpy", from_numpy)
        recons, bits, ok, *_ = run.roundtrip()
        monkeypatch.undo()
    assert rec.reads == [("__int__", "decode_blocks_hot_plain")], rec.reads
    assert bool(ok) and recons.shape == (T, H, W) and int(bits.sum()) > 0
