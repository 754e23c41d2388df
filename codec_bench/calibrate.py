"""Readings that set the limits of a cell's check (``limits/<cell>.json``).

The benchmark's own runs never call this. For each ``--seeds`` seed it
makes one run of the cell at its own size and load with a short window
and prints the numbers the check compared; for each ``--control-seeds``
seed and each ``--kinds`` it puts the reference in the program's place and
prints the same numbers. The control is the plain reference computed one
precision below what the configuration states (float32 with TF32 off): the
two transforms' products take TF32 operands
(``reference/codec.py::tf32_matmul``) and the motion search's SSDs are
bfloat16. In the stream cells the control codes each kept GOP itself (its
own motion search, symbols, codebook and decoder chain); in the decode
cells it decodes the set-up's containers itself, and ``encoder`` puts it
in the set-up encoder's place. ``stale_code`` plants a stale codebook in
the full-precision reference. A codec judge that owns its numbers
(``NUMBERS``) makes its own control of each kind (``judge.control``).
Every seed runs in this one process.

    python3 codec_bench/calibrate.py --workload fused_1080p.stream \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numbers(manifest: Path, workload: str, seed: int, device: str,
                    kind: str = "control") -> dict:
    """The check's numbers with the reference in the program's place.

    ``control``: one precision below the configuration's, in the timed
    path's place (a decode loop's decoder; a round trip's whole coder);
    ``encoder``: the same control in the encoder's place (a decode loop's
    set-up); ``stale_code``: the full-precision reference whose codebook is
    stale (the codec judge's ``rates(..., stale=True)``). A judge that owns
    its numbers gives the kept units of each kind itself:
    ``judge.control(kind, cell, gops, clip, picks, device)``.
    """
    import numpy as np
    import torch

    from codec_bench import checks, harness
    from codec_bench.reference import codec as ref

    cell = harness.Cell(manifest, workload)
    cfg, mix, judge = cell.cfg, cell.traffic, cell.judge
    dev = torch.device(device)
    n = mix["clip_gops"]
    clip, gops = cell.input.make(seed, cfg, n, dev)
    rng = np.random.default_rng(seed)
    picks = sorted(int(i) % n for i in rng.choice(np.arange(2, mix["check_within"]),
                                                   size=mix["check_gops"], replace=False))
    if hasattr(judge, "NUMBERS"):
        kept = judge.control(kind, cell, gops, clip, picks, dev)
        return checks.judge_kept(judge, kept, gops, None, cfg, clip, dev)
    T, sr = cfg["T"], cfg["sr"]
    kept = []
    if kind == "control" and cell.loop.CONTAINERS:
        # the program's containers, decoded by the control
        tr = ref.Transform(cfg["q"], dev, matmul=ref.tf32_matmul)
        prog = cell.program(cfg, dev, harness.Spans())
        prog.prepare(clip, gops)
        _, blobs = cell.loop.build(prog, gops)
        del prog
        for g in picks:
            p = checks.parse(judge, blobs[g], dev)
            recons = ref.reconstruct_gop(p["qsyms"], p["mvs"], tr, sr, cfg["H"], cfg["W"])
            kept.append({"gop": g, "recons": recons})
        return checks.judge_kept(judge, kept, gops, blobs, cfg, clip, dev)

    low = kind in ("control", "encoder")
    tr = ref.Transform(cfg["q"], dev, matmul=ref.tf32_matmul if low else ref.f64_matmul)
    ssd = torch.bfloat16 if low else torch.float64
    rates = judge.rates(clip, cfg, dev, tr=tr, stale=kind == "stale_code")
    for g in picks:
        qsyms, mvs, recons = ref.encode_gop(gops[g], tr, sr, ssd)
        tokens = [ref.zerorun_tokens(qsyms[t]) for t in range(T)]
        kept.append({"gop": g, "qsyms": qsyms, "mvs": mvs, "recons": recons,
                     "totals": rates(tokens)})
    return checks.judge_kept(judge, kept, gops, None, cfg, clip, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--kinds", default="control",
                    help="comma-separated: control, encoder, stale_code")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from codec_bench import harness

    manifest = ROOT / "BENCHMARK.json"
    for s in filter(None, args.seeds.split(",")):
        t = time.perf_counter()
        r = harness.run(manifest, args.workload, int(s), args.seconds, False, args.device,
                        log=lambda m: None)
        nums = {k: v["value"] for k, v in r["checks"].items()}
        print(json.dumps({"workload": args.workload, "side": "program", "seed": int(s),
                          "correct": r["correct"], "numbers": nums,
                          "s": round(time.perf_counter() - t, 1)}), flush=True)
    limits = harness.Cell(manifest, args.workload).limits
    for kind in filter(None, args.kinds.split(",")):
        for s in filter(None, args.control_seeds.split(",")):
            t = time.perf_counter()
            nums = control_numbers(manifest, args.workload, int(s), args.device, kind)
            # the harness's own comparison over the cell's limits
            _, correct = harness.verdict(nums, limits, 0)
            print(json.dumps({"workload": args.workload, "side": kind, "seed": int(s),
                              "correct": correct, "numbers": nums,
                              "s": round(time.perf_counter() - t, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
