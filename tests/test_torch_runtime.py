"""The port's runtime aux modules against the JAX package's.

``runtime/trace.py`` (the twin of ``tests/test_runtime.py::test_stage_timer``,
``record_function`` names in a CPU profile, a Chrome trace on disk),
``runtime/debug.py`` (the three checkify tests of
``tests/test_debug_fault.py`` with JAX's messages, the eager checks outside
``checked``, ``debug_mode``), ``runtime/elastic.py`` (the heartbeat monitor
twin, ``DistributedHeartbeat`` over an in-process store and its refusal
without a process group, ``reencode_missing_gops``' bytes against JAX's)
and ``tools/dryrun.py``: ``dryrun_multichip`` on in-process CPU meshes of
1, 2, 4 and 8 shards, and ``entry`` against ``__graft_entry__.entry``
under ``jax.jit``. Sizes are the JAX tests': foreman cut to 96x128 for the
recovery, the dry run's 64-pixel-wide frames, the entry's 64x64x3 input.
Bytes and symbols must be equal; the one float comparison (the entry's
reconstruction) states its bound.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import reference_state

from ivclab_tpu.models.fastvideo import FusedVideoCodec as JaxCodec
from ivclab_tpu.runtime import debug as jdebug
from ivclab_tpu.runtime.elastic import reencode_missing_gops as jax_reencode
from ivclab_tpu.runtime.trace import StageTimer as JaxStageTimer

from ivclab_tpu_torch import FusedVideoCodec as TorchCodec
from ivclab_tpu_torch import runtime as truntime
from ivclab_tpu_torch.runtime.debug import (
    CheckError,
    assert_finite,
    assert_in_range,
    checked,
    debug_mode,
)
from ivclab_tpu_torch.runtime.elastic import (
    DistributedHeartbeat,
    HeartbeatMonitor,
    reencode_missing_gops,
)
from ivclab_tpu_torch.runtime.trace import StageTimer, device_trace
from ivclab_tpu_torch.tools.dryrun import dryrun_multichip, entry


def test_stage_timer():
    t = StageTimer(annotate=False)
    with t.stage("a"):
        sum(range(1000))
    with t.stage("a"):
        pass
    rep = t.report()
    assert rep["a"]["calls"] == 2
    assert rep["a"]["total_s"] >= 0
    j = JaxStageTimer(annotate=False)
    with j.stage("a"):
        pass
    assert sorted(rep["a"]) == sorted(j.report()["a"]) == ["calls", "mean_ms", "total_s"]
    assert json.loads(t.dump()) == rep
    off = StageTimer(enabled=False)
    with off.stage("a", sync=torch.ones(1)):
        pass
    assert off.report() == {}


def test_stage_sync_takes_tensors_and_raises_its_own_errors():
    t = StageTimer(annotate=False)
    with t.stage("one", sync=torch.ones(2)):
        pass
    with t.stage("two", sync=(torch.ones(2), torch.zeros(3))):
        pass
    assert t.report()["two"]["calls"] == 1
    with pytest.raises(AttributeError):  # not a tensor: no silent skip
        with t.stage("bad", sync="not a tensor"):
            pass
    assert "bad" not in t.report()


def test_stage_annotations_appear_in_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    t = StageTimer(annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.stage("ivc-encode-stage"):
            torch.ones(64).cumsum(0)
        with t.stage("ivc-pack-stage"):
            torch.ones(8) * 2
    names = {e.key for e in prof.key_averages()}
    assert {"ivc-encode-stage", "ivc-pack-stage"} <= names


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        (torch.ones(128, 128) @ torch.ones(128, 128)).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


def test_checked_passes():
    fn = checked(lambda x: assert_finite(x * 2, "x"))
    out = fn(torch.ones(4))
    assert torch.allclose(out, torch.full((4,), 2.0))


def _jax_message(fn, x) -> str:
    with pytest.raises(ValueError) as e:
        fn(x)
    return str(e.value)


def test_checked_catches_nonfinite():
    fn = checked(lambda x: assert_finite(torch.log(x), "logx"))
    with pytest.raises(CheckError, match="non-finite") as e:
        fn(torch.zeros(4) - 1.0)
    want = _jax_message(jdebug.checked(lambda x: jdebug.assert_finite(jnp.log(x), "logx")),
                        jnp.zeros(4) - 1.0)
    assert str(e.value) == want == "non-finite values in logx (`check` failed)"


def test_range_check():
    fn = checked(lambda x: assert_in_range(x, 0, 10, "sym"))
    fn(torch.arange(10))
    with pytest.raises(CheckError, match="outside") as e:
        fn(torch.arange(12))
    want = _jax_message(jdebug.checked(lambda x: jdebug.assert_in_range(x, 0, 10, "sym")),
                        jnp.arange(12))
    assert str(e.value) == want == "sym outside [0, 10) (`check` failed)"


def test_checks_outside_checked_raise_eagerly_as_jax_does():
    """JAX runs a ``checkify.check`` called eagerly outside ``checked`` on
    the spot and raises the same error; the port's checks do the same, and
    pass their input through when it is good."""
    with pytest.raises(ValueError) as jerr:
        jdebug.assert_finite(jnp.log(jnp.zeros(3) - 1.0), "y")
    with pytest.raises(CheckError) as terr:
        assert_finite(torch.log(torch.zeros(3) - 1.0), "y")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jdebug.assert_in_range(jnp.arange(3), 5, 9, "y")
    with pytest.raises(CheckError) as terr:
        assert_in_range(torch.arange(3), 5, 9, "y")
    assert str(terr.value) == str(jerr.value)
    assert type(jerr.value).__mro__[1] is ValueError and isinstance(terr.value, ValueError)
    x = torch.ones(3)
    assert assert_finite(x) is x and assert_in_range(x, 0, 2) is x


def test_debug_mode_raises_on_nan_and_inf_and_restores_on_exit():
    with debug_mode():
        torch.ones(3) + 1  # finite results pass
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.log(torch.zeros(2) - 1.0)
        with pytest.raises(FloatingPointError, match="inf"):
            torch.ones(2) / 0.0
    with debug_mode(nans=True, infs=False):
        torch.ones(2) / 0.0
        with pytest.raises(FloatingPointError):
            torch.zeros(1) / 0.0
    assert torch.isnan(torch.zeros(1) / 0.0).all()  # the previous state: no checks
    with debug_mode(nans=False, infs=True):
        with debug_mode(nans=True, infs=False):
            with pytest.raises(FloatingPointError):
                torch.zeros(1) / 0.0
        torch.zeros(1) / 0.0  # the enclosing mode only checks infs again
        with pytest.raises(FloatingPointError):
            torch.ones(1) / 0.0
    assert torch.isinf(torch.ones(1) / 0.0).all()


def test_runtime_exports():
    for name in ("StageTimer", "device_trace", "checked", "assert_finite", "assert_in_range",
                 "debug_mode", "HeartbeatMonitor", "DistributedHeartbeat",
                 "reencode_missing_gops", "native"):
        assert name in truntime.__all__ and hasattr(truntime, name)


def test_heartbeat_monitor_detects_drop():
    t = [0.0]
    mon = HeartbeatMonitor(hosts=[0, 1, 2, 3], timeout_s=5.0, clock=lambda: t[0])
    t[0] = 3.0
    mon.report(0); mon.report(1); mon.report(3)
    assert mon.dead_hosts() == []
    t[0] = 7.0  # host 2 last seen at 0.0 -> dead; others at 3.0 -> alive
    assert mon.dead_hosts() == [2]
    assert sorted(mon.alive_hosts()) == [0, 1, 3]
    mon.report(2)  # host rejoins
    assert mon.dead_hosts() == []


def test_distributed_heartbeat_over_a_store():
    """Two processes' heartbeats through one in-process store: a peer that
    has not reported never blocks the poll, a silent peer ages out."""
    import torch.distributed as dist

    store = dist.HashStore()
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    hb = [DistributedHeartbeat(HeartbeatMonitor(range(2), 5.0, clock), store=store, rank=r,
                               world_size=2) for r in range(2)]
    assert hb[0].report() == 1
    assert hb[0].poll() == {0: 1}  # rank 1 has not reported: skipped, not waited for
    hb[1].report()
    hb[1].report()
    assert hb[0].poll() == {0: 1, 1: 2}
    t[0] = 4.0
    hb[0].report()
    assert hb[0].poll() == {0: 2, 1: 2} and hb[0].dead_hosts() == []
    t[0] = 8.0  # rank 1 stopped advancing at t=0
    hb[0].report()
    hb[0].poll()
    assert hb[0].dead_hosts() == [1] and hb[0].alive_hosts() == [0]


def test_distributed_heartbeat_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        DistributedHeartbeat()
    with pytest.raises(RuntimeError, match="not initialized"):
        DistributedHeartbeat(store=dist.HashStore())  # rank and world size come from the group


def test_simulated_host_drop_recovery(foreman):
    """Drop one GOP-owning host from a sharded encode: the port re-encodes
    only that GOP, and its bytes are the JAX package's."""
    gop_len = 2
    y = foreman[:6, :96, :128].astype(np.float32).mean(axis=-1)
    j = JaxCodec(quantization_scale=1.0).train(y[:2])
    full = [j.encode_to_container(y[g * gop_len:(g + 1) * gop_len]) for g in range(3)]
    broken = [full[0], None, full[2]]
    codec = TorchCodec.from_reference_state(reference_state(j), device="cpu")
    repaired = reencode_missing_gops(codec, y, broken, gop_len)
    assert repaired == jax_reencode(j, y, broken, gop_len) == full
    for g in range(3):
        recons, ok = TorchCodec.decode_from_container(repaired[g], device="cpu")
        ref, _ = TorchCodec.decode_from_container(full[g], device="cpu")
        assert bool(ok) and torch.equal(recons, ref)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip_on_cpu_meshes(n):
    """``dryrun_multichip(n)`` on an in-process CPU mesh (JAX's default
    factorisation: 1x1, 1x2, 1x4, 2x4); it raises on any failed check."""
    dryrun_multichip(n, device="cpu")


def test_entry_matches_the_graft_entry():
    """The fused intra forward step against ``__graft_entry__.entry()``
    jitted: the same input, symbol count and quantised symbols exactly, the
    reconstruction within 1e-4 (one float32 [N,64]x[64,64] product each
    way; 0.0 measured)."""
    from ivclab_tpu.ops.transform import forward_symbolize as jax_forward_symbolize

    from ivclab_tpu_torch.ops.transform import forward_symbolize

    path = Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jfn, jargs = graft.entry()
    jrec, jcount = jax.jit(jfn)(*jargs)
    fn, args = entry(device="cpu")
    assert np.array_equal(args[0].numpy(), jargs[0])
    rec, count = fn(*args)
    assert int(count) == int(jcount) > 0
    assert float(np.abs(rec.numpy() - np.asarray(jrec)).max()) <= 1e-4

    from ivclab_tpu_torch.ops.quant import quant_table_zigzag

    inv = (1.0 / quant_table_zigzag(0.5, 3)).astype(np.float32)
    _, jvalid, jq = jax_forward_symbolize(jnp.asarray(jargs[0]), jnp.asarray(inv), 4000)
    _, valid, q = forward_symbolize(args[0], torch.from_numpy(inv), 4000)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        entry()
