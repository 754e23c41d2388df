"""What the benchmark's command loads: never JAX nor the JAX package, the
reference and the input kinds nothing of the program; no card, no
result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from codec_bench.tests.tiny import ROOT

ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _py(code: str, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV, capture_output=True,
                          text=True, timeout=300)


def test_a_cpu_rehearsal_loads_no_jax(tmp_path):
    code = f"""
import sys, pathlib
sys.path.insert(0, {str(ROOT)!r})
from codec_bench import harness, calibrate
from codec_bench.tests.tiny import tiny_root
m = tiny_root(pathlib.Path({str(tmp_path)!r}))
for cell in ("fused_1080p.stream", "adaptive_1080p.decode"):
    harness.run(m, cell, 9, 0.3, False, device="cpu", log=lambda s: None)
print(harness.forbidden_modules())
"""
    p = _py(code)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import codec_bench.reference.codec, codec_bench.reference.bitstream, codec_bench.reference.judge
from codec_bench import checks, harness
root = harness.Path({str(ROOT)!r})
for f in sorted([*root.glob("codec_bench/codec/*/judge.py"),
                 *root.glob("codec_bench/inputs/*.py")]):
    harness.load(f, f.parent.name + "_" + f.stem)
print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'ivclab_tpu_torch', 'ivclab_tpu', 'jax', 'jaxlib'}}))
"""
    p = _py(code)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


def _run_on_the_cpu(tiny, monkeypatch, args):
    """``run.main`` as on the card, with the tiny checkout and the CPU in
    its place: (exit code, standard output)."""
    import torch

    from codec_bench import run

    monkeypatch.setattr(run, "ROOT", tiny.parent)
    monkeypatch.setattr(run, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    return run.main(args)


@pytest.mark.parametrize("trace,where", [(1, "reader"), (0, "check")])
def test_a_forbidden_module_loaded_after_the_window_voids_the_run(tiny, monkeypatch, capsys,
                                                                  trace, where):
    """A per-layer reader, or a lazy import in the check, that loads a
    module named ``jax`` (a stub) once the window has closed: exit 3, no
    result line."""
    stub = "import sys, types\nsys.modules.setdefault('jax', types.ModuleType('jax'))\n"
    if where == "reader":
        (tiny.parent / "codec_bench/metrics/dispatch_ms.py").write_text(
            stub + "\n\ndef read(ctx):\n    return 1.0\n")
    else:
        judge = tiny.parent / "codec_bench/codec/FusedVideoCodec/judge.py"
        judge.write_text(judge.read_text().replace(
            "    dev = torch.device(device)\n    tr = tr or", "    " + stub.replace(
                "\n", "\n    ").rstrip() + "\n    dev = torch.device(device)\n    tr = tr or"))
    args = ["--workload", "fused_1080p.stream", "--seed", "5", "--seconds", "4",
            "--trace", str(trace)]
    assert "jax" not in sys.modules
    try:
        rc = _run_on_the_cpu(tiny, monkeypatch, args)
    finally:
        loaded = sys.modules.pop("jax", None)
    assert loaded is not None
    assert rc == 3 and capsys.readouterr().out.strip() == ""


def test_a_clean_run_prints_its_line_last(tiny, monkeypatch, capsys):
    # the CPU profiler's read of the slice takes seconds of the window
    args = ["--workload", "fused_1080p.stream", "--seed", "5", "--seconds", "8",
            "--trace", "1"]
    assert _run_on_the_cpu(tiny, monkeypatch, args) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"]
    assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    assert "dispatch_ms" in line["metrics"]


def test_forbidden_names_are_compared_whole():
    from codec_bench import harness

    assert "ivclab_tpu_torch" not in harness.forbidden_modules()
    sys.modules["ivclab_tpu"] = sys.modules.get("ivclab_tpu") or type(sys)("ivclab_tpu")
    try:
        assert "ivclab_tpu" in harness.forbidden_modules()
    finally:
        del sys.modules["ivclab_tpu"]


def test_no_card_no_result(tmp_path):
    args = ["--workload", "fused_1080p.stream", "--seed", "1", "--seconds", "1", "--trace", "0"]
    p = subprocess.run([sys.executable, "codec_bench/run.py", *args], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=300)
    if p.returncode == 0:  # a card is here: the run's own business
        return
    assert p.stdout.strip() == ""
    # a checkout that holds only the manifest and the benchmark's folder
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "codec_bench", tmp_path / "codec_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    p = subprocess.run([sys.executable, "codec_bench/run.py", *args], cwd=tmp_path, env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
