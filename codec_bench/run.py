"""The port's benchmark: one run of one cell on the card.

    python3 codec_bench/run.py --workload fused_1080p.stream --seed 7 --seconds 40 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` GOPs, the cell's end-to-end metrics (``--trace
0``) or its per-layer metrics (``--trace 1``, with ``breakdown``), the
``device``, and last the ``checks``: every number the check compared beside
its limit (also the last lines of standard error). Without a CUDA card, or
with fewer cards than the cell asks for, it exits with 2 and prints no
result; if the measuring process holds a JAX module or the JAX package
once the window, the check and the per-layer readers are done, with 3 and
no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DEVICE = "cuda"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    manifest = ROOT / "BENCHMARK.json"
    cells = {w["name"]: w for w in json.loads(manifest.read_text())["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in {manifest}", file=sys.stderr)
        return 2
    need = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    from codec_bench import harness

    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    result = harness.run(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                         device=DEVICE, t_start=T_START, log=log)
    # the window has closed, the check and the readers have run: whatever
    # loaded a forbidden module by now voids the run
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
