"""A tiny copy of the benchmark for CPU tests: a temporary checkout root
holding the manifest and the data files, with every configuration cut to
64x128 frames (the code is imported from the real package)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
TINY = {"H": 64, "W": 128}


def tiny_root(tmp: Path, seconds_limits: dict | None = None) -> Path:
    """Copy the manifest and the folders found by name to ``tmp`` with tiny frames;
    returns the manifest's path."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("traffic", "limits", "metrics", "loops", "codec", "inputs"):
        shutil.copytree(BENCH / sub, tmp / "codec_bench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "codec_bench" / "configs").mkdir(parents=True)
    for conf in manifest["configs"]:
        cfg = json.loads((ROOT / conf["file"]).read_text())
        cfg.update(TINY)
        (tmp / conf["file"]).write_text(json.dumps(cfg))
    for mix in (tmp / "codec_bench" / "traffic").glob("*.json"):
        t = json.loads(mix.read_text())
        t.update(check_within=4, warm_cycles=1, trace_gops=2)
        mix.write_text(json.dumps(t))
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    return path
