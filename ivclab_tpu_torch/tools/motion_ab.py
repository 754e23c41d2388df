"""Time two builds of the motion-search kernel in turns on one card.

    python3 -m ivclab_tpu_torch.tools.motion_ab OTHER.cu [--sr 4] [--launches 50] [--rounds 2]

``OTHER.cu`` is any source with the C interface of
``ivclab_tpu_torch/csrc/motion_search.cu``, for example an earlier revision
of it written to an ignored path (``git show REV:ivclab_tpu_torch/csrc/
motion_search.cu > ivclab_tpu_torch/csrc/_build/other/motion_search.cu``).
Both sources are built with the kernels' nvcc flags and fed the same
inputs at search range ``--sr`` (default 4): the 1088x1920 ``bench``
fixture frame pair (luma) and its second 272-row band with its halo rows.
The two builds must return the same indices. Then they are timed in turns
(other, this, this, other per round): each time is the mean device
duration of one launch of the kernel the range runs (``wide_kernel`` at
sr 0 and sr >= 16, ``me_kernel`` otherwise) over ``--launches`` launches
in a ``torch.profiler`` trace, beside the CUDA-event time per call, which
includes the host's enqueue. Prints the card's name and power limit, then
one JSON object. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ivclab_tpu_torch.ops import motion
from ivclab_tpu_torch.runtime import cuda_build
from ivclab_tpu_torch.utils import fixtures
from ivclab_tpu_torch.utils.timing import cuda_ms, kernel_device_us, motion_search_bound


def kernel_name(sr: int) -> str:
    """The kernel that the checkout's build launches at range sr, as the
    profiler names it."""
    return "wide_kernel" if motion._lib().ivc_motion_search_wide(sr) else "me_kernel"


def frame_call(lib, ref, cur, out, sr):
    H, W = cur.shape
    args = (ref.data_ptr(), cur.data_ptr(), out.data_ptr(), H, W, sr,
            torch.cuda.current_stream().cuda_stream)

    def call():
        rc = lib.ivc_motion_search(*args)
        if rc:
            raise RuntimeError(f"ivc_motion_search failed (cudaError {rc})")
    return call


def band_call(lib, ext, band, out, row0, total_h, sr):
    Ht, W = band.shape
    args = (ext.data_ptr(), ext.shape[0], band.data_ptr(), out.data_ptr(), Ht, W, sr, row0,
            total_h, torch.cuda.current_stream().cuda_stream)

    def call():
        rc = lib.ivc_motion_search_tile(*args)
        if rc:
            raise RuntimeError(f"ivc_motion_search_tile failed (cudaError {rc})")
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="a .cu source with motion_search.cu's C interface")
    ap.add_argument("--sr", type=int, default=4, help="search range (default 4)")
    ap.add_argument("--launches", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("motion_ab: needs a CUDA card", file=sys.stderr)
        return 1

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60
                          ).stdout.strip().splitlines()[0]
    print(card)
    libs = {}
    for name, src in (("this", cuda_build.CSRC / "motion_search.cu"), ("other", args.other)):
        path, log = cuda_build.build_file(src.resolve())
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")):
                print(f"[{name}] {line.strip()}")
        libs[name] = motion.bind(ctypes.CDLL(str(path)))

    H, W, n_bands = 1088, 1920, 4
    band_h = H // n_bands
    y = fixtures.video("bench", 2, (H, W)).astype(np.float32).mean(axis=-1)
    dev = torch.device("cuda")
    ref = torch.from_numpy(np.ascontiguousarray(y[0])).to(dev)
    cur = torch.from_numpy(np.ascontiguousarray(y[1])).to(dev)
    sr = args.sr
    padded = torch.nn.functional.pad(ref, (0, 0, sr, sr))
    ext = padded[band_h:2 * band_h + 2 * sr].contiguous()
    band = cur[band_h:2 * band_h].contiguous()

    outs = {name: (torch.empty((H // 8, W // 8), dtype=torch.int32, device=dev),
                   torch.empty((band_h // 8, W // 8), dtype=torch.int32, device=dev))
            for name in libs}
    calls = {name: {"frame": frame_call(lib, ref, cur, outs[name][0], sr),
                    "band": band_call(lib, ext, band, outs[name][1], band_h, H, sr)}
             for name, lib in libs.items()}
    for name in libs:
        for fn in calls[name].values():
            fn()
    torch.cuda.synchronize()
    same = {"frame": torch.equal(outs["this"][0], outs["other"][0]),
            "band": torch.equal(outs["this"][1], outs["other"][1])}
    print(f"[ab] same indices: {same}")

    result = {"card": card, "sr": sr, "kernel": kernel_name(sr), "launches": args.launches,
              "same": same}
    for entry, (ref_rows, rows) in {"frame": (H, H), "band": (band_h + 2 * sr, band_h)}.items():
        bound_ms, bound_by = motion_search_bound(ref_rows, rows, W, sr)
        times = {name: {"device_us": [], "event_ms": []} for name in libs}
        for name in libs:
            for _ in range(3):
                calls[name][entry]()
        for _ in range(args.rounds):
            for name in ("other", "this", "this", "other"):
                fn = calls[name][entry]
                us = kernel_device_us(fn, args.launches, kernel_name(sr))
                times[name]["device_us"].append(float(np.mean(us)))
                times[name]["event_ms"].append(cuda_ms(fn, args.launches))
        for name in libs:
            t = times[name]
            t["device_ms_mean"] = float(np.mean(t["device_us"])) / 1e3
            t["share_of_bound"] = bound_ms / t["device_ms_mean"]
        ratio = times["this"]["device_ms_mean"] / times["other"]["device_ms_mean"]
        result[entry] = {"shape": [rows, W], "bound_ms": bound_ms, "bound_by": bound_by,
                         "this_over_other": ratio, **times}
        print(f"[ab] {entry} {rows}x{W} sr={sr} {kernel_name(sr)}: this "
              f"{times['this']['device_us']} us, other {times['other']['device_us']} us (device, "
              f"mean of {args.launches} launches), this/other {ratio:.4f}; bound "
              f"{bound_ms * 1e3:.3f} us ({bound_by}); {card}")
    print(json.dumps(result))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
