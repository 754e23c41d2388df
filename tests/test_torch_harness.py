"""The parity tests' own harness: the reference C++ engine builds once, safely.

Every pytest-xdist worker imports ``torch_parity`` while it collects and
builds the JAX package's ``entropy.cpp`` there under a lock, so that
workers never race on the first build of the library (see
``torch_parity.prebuild_reference_native``).
"""

import ctypes
import hashlib
import subprocess
import sys
import textwrap
import time
from pathlib import Path

from torch_parity import _NATIVE, prebuild_reference_native

TESTS = Path(__file__).resolve().parent

_WORKER = textwrap.dedent("""
    import ctypes, sys, time
    from pathlib import Path
    sys.path.insert(0, sys.argv[1])
    from torch_parity import prebuild_reference_native
    src, build, gate = Path(sys.argv[2]), Path(sys.argv[3]), Path(sys.argv[4])
    (gate / f"ready.{sys.argv[5]}").touch()
    deadline = time.monotonic() + 60
    while not (gate / "go").exists():
        if time.monotonic() > deadline:
            sys.exit("no go signal")
        time.sleep(0.005)
    lib = prebuild_reference_native(src, build)
    ctypes.CDLL(str(lib))
    print(lib)
""")


def test_six_processes_build_one_library(tmp_path):
    src = tmp_path / "entropy.cpp"
    src.write_bytes((_NATIVE / "entropy.cpp").read_bytes())
    build, gate = tmp_path / "_build", tmp_path / "gate"
    gate.mkdir()
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(TESTS), str(src), str(build),
                               str(gate), str(k)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for k in range(6)]
    try:
        deadline = time.monotonic() + 90
        while len(list(gate.glob("ready.*"))) < 6 and time.monotonic() < deadline:
            time.sleep(0.01)
        (gate / "go").touch()  # all six start the build together
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    want = build / f"libivclab_native_{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == str(want)
    assert sorted(f.name for f in build.iterdir()) == sorted([want.name, "prebuild.lock"])
    ctypes.CDLL(str(want))


def test_prebuild_skips_a_missing_source_and_reuses_a_build(tmp_path):
    assert prebuild_reference_native(tmp_path / "absent.cpp", tmp_path / "_build") is None
    assert not (tmp_path / "_build").exists()
    built = prebuild_reference_native()
    if built is not None:  # the repo's own library: built at collection
        assert built.parent == _NATIVE / "_build"
        mtime = built.stat().st_mtime_ns
        assert prebuild_reference_native() == built
        assert built.stat().st_mtime_ns == mtime
