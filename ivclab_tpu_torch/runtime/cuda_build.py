"""Build the port's native code at first use; load it with ctypes.

Two kinds of source live in ``csrc/``, both with a plain C interface:

- ``<name>.cu``, the hand-written CUDA kernels, compiled by ``nvcc``
  (:func:`build`, :func:`load`);
- ``entropy.cpp``, the serial C++ entropy engine, compiled by ``g++``
  (:func:`build_host`; loaded by ``runtime/native.py``).

Each builds into ``csrc/_build/<name>_<hash>.so``, where the hash covers the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. Builds are safe to race: processes that reach an empty build
directory together take an exclusive ``fcntl`` lock, re-check for the
library once they hold it, and compile to a pid-unique temporary name that
is renamed into place, so no process ever loads a half-written library.
Nothing is fetched: the sources come from the checkout, ``nvcc`` from the
CUDA toolkit (``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``) and
``g++`` from ``PATH``. A failed build raises with the compiler's stderr.

Nothing here runs at import time, so the package imports on machines
without a GPU, a CUDA toolkit or a C++ compiler.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def find_cxx() -> str | None:
    """The host C++ compiler (``g++`` on ``PATH``), or None where there is none."""
    return shutil.which("g++")


def _hashed(src: Path, flags, build_dir: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return build_dir / f"{src.stem}_{digest.hexdigest()[:16]}.so"


def _compile(src: Path, out: Path, cmd: list[str]) -> str:
    """Run ``cmd -o <tmp> src`` and rename the result to ``out``, once across
    processes. Returns the compiler's stderr, or ``""`` if ``out`` existed."""
    if out.exists():
        return ""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f"{out.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return ""
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run([*cmd, "-o", str(tmp), str(src)], capture_output=True,
                                  text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{Path(cmd[0]).name} failed building {src.name}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)  # a failed or timed-out compile leaves no partial file
        return proc.stderr


def library_path(name: str) -> Path:
    """Where the content-hashed build of ``csrc/<name>.cu`` lives."""
    return _hashed(CSRC / f"{name}.cu", NVCC_FLAGS, BUILD_DIR)


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its hashed build exists.

    Returns ``(path, log)``; ``log`` is nvcc's stderr (ptxas register and
    shared-memory report) or ``""`` when the cached build was reused.
    """
    return build_file(CSRC / f"{name}.cu")


def build_file(src: Path, build_dir: Path = BUILD_DIR) -> tuple[Path, str]:
    """Compile any ``.cu`` source with the kernels' nvcc flags into
    ``build_dir`` unless its hashed build exists; returns ``(path, log)``."""
    out = _hashed(src, NVCC_FLAGS, build_dir)
    if out.exists():
        return out, ""
    return out, _compile(src, out, [find_nvcc(), *NVCC_FLAGS])


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def build_host(src: Path = CSRC / "entropy.cpp", build_dir: Path = BUILD_DIR) -> tuple[Path, str]:
    """Compile a C++ source with ``g++ -O3 -std=c++17 -shared -fPIC`` unless
    its hashed build exists in ``build_dir``. Returns ``(path, log)``.

    Raises ``FileNotFoundError`` where there is no ``g++`` and
    ``RuntimeError`` (with g++'s stderr) when the compile fails.
    """
    out = _hashed(src, HOST_FLAGS, build_dir)
    if out.exists():
        return out, ""
    cxx = find_cxx()
    if cxx is None:
        raise FileNotFoundError("g++ not found on PATH")
    return out, _compile(src, out, [cxx, *HOST_FLAGS])
