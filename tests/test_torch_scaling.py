"""``ivclab_tpu_torch/tools/scaling.py`` against the JAX ``bench_scaling.py``.

``bench_scaling.py`` is loaded by path (its ``main`` writes ``SCALING.json``,
so only ``comm_model`` and the constants are called). The port's tool must
keep the JAX tool's workloads (constants, frames) and ``comm_model()``;
its gop and tile points run on in-process CPU meshes of 1 and 2 shards
with the pack buckets' adequacy checked; and over gloo ranks in
subprocesses (120 s limit each) its profiler census must give each rank's
halo and reduction bytes as the model counts them, the assembly
all-gathers apart, in a report with every key of ``SCALING.json``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread)

from ivclab_tpu.utils import fixtures as jfixtures

from ivclab_tpu_torch.parallel import make_mesh
from ivclab_tpu_torch.tools import scaling
from ivclab_tpu_torch.utils import fixtures as tfixtures

REPO = Path(__file__).resolve().parents[1]
CONSTANTS = ("GOP_LEN", "H", "W", "ITERS", "REPEATS", "TILE_BAND_H", "TILE_W", "TILE_GOP_LEN",
             "TILE_CAP", "TILE_BW", "TILE_GW")


@pytest.fixture(scope="module")
def bench_scaling():
    spec = importlib.util.spec_from_file_location("jax_bench_scaling", REPO / "bench_scaling.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def short_rank_limit(monkeypatch):
    monkeypatch.setattr(scaling, "RANK_TIMEOUT_S", 120)


def _keys(d, prefix=""):
    """Every key path of a JSON report; a list's entries share the path."""
    out = set()
    if isinstance(d, dict):
        for k, v in d.items():
            out.add(prefix + k)
            out |= _keys(v, prefix + k + ".")
    elif isinstance(d, list) and d and isinstance(d[0], dict):
        for item in d:
            out |= _keys(item, prefix + "[].")
    return out


def test_workloads_and_comm_model_equal_jax(bench_scaling):
    for name in CONSTANTS:
        assert getattr(scaling, name) == getattr(bench_scaling, name), name
    port, jax = scaling.comm_model(), bench_scaling.comm_model()
    # the assumptions text names each package's census (HLO / profiler)
    assert {k: v for k, v in port.items() if k != "assumptions"} == {
        k: v for k, v in jax.items() if k != "assumptions"}
    for name, T, shape in (("scaling", 2 * scaling.GOP_LEN, (scaling.H, scaling.W)),
                           ("scaling-tile", scaling.TILE_GOP_LEN, (2 * scaling.TILE_BAND_H,
                                                                   scaling.TILE_W))):
        assert np.array_equal(tfixtures.video(name, T, shape), jfixtures.video(name, T, shape))


@pytest.mark.parametrize("axis", ["gop", "tile"])
@pytest.mark.parametrize("n", [1, 2])
def test_in_process_point(axis, n):
    """One point on an in-process CPU mesh: the buckets hold, the loops are
    timed, the result has the JAX child's keys, and no collective runs."""
    mesh = make_mesh(*scaling.mesh_shape(axis, n), device="cpu")
    r = scaling.run_point(axis, n, mesh)
    assert r["n_devices"] == n and r["iters"] == scaling.ITERS
    assert len(r["repeats_mpix_per_s"]) == scaling.REPEATS and r["mpix_per_s"] > 0
    if axis == "gop":
        assert r["frames"] == n * scaling.GOP_LEN
    else:
        assert r["frame"] == [n * scaling.TILE_BAND_H, scaling.TILE_W]
        assert r["collective_census"] == []


def test_two_gloo_ranks_census_and_report(tmp_path, capsys, short_rank_limit):
    """The distributed sweep at 1 and 2 ranks (one timed step a point): the
    census of each tile rank holds its halo and reduction bytes to the
    model, the all-gathers are totalled apart, and the report carries every
    key of the JAX tool's ``SCALING.json``."""
    out = tmp_path / "SCALING_torch.json"
    assert scaling.main(["--device", "cpu", "--distributed", "--counts", "1,2", "--iters", "1",
                         "--repeats", "1", "--out", str(out)]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    rep = json.loads(out.read_text())
    jax_rep = json.loads((REPO / "SCALING.json").read_text())
    assert _keys(jax_rep) <= _keys(rep), _keys(jax_rep) - _keys(rep)
    assert rep["mode"] == "distributed" and rep["device"] == "cpu"

    model = scaling.comm_model()["per_device_per_gop"]
    two = next(r for r in rep["tile_axis"]["results"] if r["n_devices"] == 2)
    assert {op for op, _, _ in two["collective_census"]} == {
        "send", "recv", "all_reduce", "all_gather"}
    for rank in two["census_bytes_per_rank"]:  # both ranks are edge ranks: one neighbour
        assert rank["halo_send"] == rank["halo_recv"] == model["halo_ppermute_bytes"] // 2
        assert rank["halo_send"] + rank["halo_recv"] == model["halo_ppermute_bytes"]
        assert rank["reduce"] == model["psum_payload_bytes"]
        assert rank["assembly"] > 0 and rank["other"] == 0
    assert all(r["collective_census"] == [] for r in rep["gop_axis"]["results"]
               if "collective_census" in r)


def test_interior_rank_census_equals_the_model(short_rank_limit):
    """Three tile ranks: the middle one sends and receives both halos, which
    is what ``comm_model()`` counts per device."""
    r = scaling.run_distributed("tile", 3, iters=1, repeats=1)
    model = scaling.comm_model()["per_device_per_gop"]
    middle = r["census_bytes_per_rank"][1]
    assert middle["halo_send"] == middle["halo_recv"] == model["halo_ppermute_bytes"]
    assert middle["reduce"] == model["psum_payload_bytes"]


def test_census_check_refuses_wrong_bytes():
    model = scaling.comm_model()["per_device_per_gop"]
    good = {"halo_send": model["halo_ppermute_bytes"], "halo_recv": model["halo_ppermute_bytes"],
            "reduce": model["psum_payload_bytes"], "assembly": 123, "other": 0}
    scaling.check_census(good, 1, 3)
    with pytest.raises(RuntimeError):
        scaling.check_census(good, 0, 3)  # an edge rank sends one halo, not two
    with pytest.raises(RuntimeError):
        scaling.check_census(dict(good, reduce=4), 1, 3)
