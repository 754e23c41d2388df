"""Time two or more builds of the decode walk kernels in turns on one card.

    python3 -m ivclab_tpu_torch.tools.walk_ab OTHER.cu [MORE.cu ...] [--launches 20] [--rounds 2]

``OTHER.cu`` is any source with the C interface of
``ivclab_tpu_torch/csrc/decode_walk.cu`` (``ivc_decode_blocks_hot`` and
``ivc_decode_blocks_device``), for example an earlier revision of it
written to an ignored path (``git show REV:ivclab_tpu_torch/csrc/
decode_walk.cu > ivclab_tpu_torch/csrc/_build/other/decode_walk.cu``).
Every source is built with the kernels' nvcc flags (its ``-Xptxas -v``
report printed) and fed the walks the main paths give it at 1080p:

- ``hot_residual``: the residual walk of decoding the IVC1 container of
  ``FusedVideoCodec``'s 8-frame 1088x1920 GOP (``walk_kernel``);
- ``intra``: the walk of decoding ``IntraCodec``'s 1088x1920 RGB container
  of lena tiled, q=1.0 (``canon_walk_kernel``);
- ``adaptive_frame1``: frame 1's residual section of decoding
  ``VideoCodec``'s per-frame container of the same GOP (``canon_walk_kernel``).

The builds must return the same outputs, equal to the plain walk's. Then
each walk is timed in turns (other, this, this, other per round; with
more sources, all others, this twice, the others backwards): each time is
the mean device duration of one launch over ``--launches`` launches in a
``torch.profiler`` trace, beside its bound (``utils/timing.py``). Prints
the card's name and power limit, then one JSON object. Needs one CUDA card.
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

from ivclab_tpu_torch.ops import bitpack
from ivclab_tpu_torch.runtime import cuda_build
from ivclab_tpu_torch.utils import fixtures
from ivclab_tpu_torch.utils.timing import canon_walk_bound, decode_walk_bound, kernel_device_us


def main_path_walks(dev, H: int = 1088, W: int = 1920) -> dict:
    """{name: (kind, args)}: the three walks, captured at their call sites
    as the decodes at H x W pass them (kind "hot" or "canon")."""
    from ivclab_tpu_torch import FusedVideoCodec, IntraCodec, VideoCodec
    from ivclab_tpu_torch.models import fastvideo, intracodec, videocodec

    y = np.ascontiguousarray(fixtures.video("bench", 8, (H, W)).astype(np.float32).mean(axis=-1))
    y_dev = torch.from_numpy(y).to(dev)
    hot, canon = [], []
    real_hot, real_canon = fastvideo.decode_blocks_hot, bitpack.decode_blocks_device

    def spy_hot(*args):
        hot.append(args)
        return real_hot(*args)

    def spy_canon(*args, **kw):
        canon.append(args[:5])
        return real_canon(*args, **kw)

    fastvideo.decode_blocks_hot = spy_hot
    intracodec.decode_blocks_device = videocodec.decode_blocks_device = spy_canon
    try:
        codec = FusedVideoCodec(1.0, 4, device=dev).train(y[:2])
        FusedVideoCodec.decode_from_container(codec.encode_to_container(y_dev), device=dev)
        lena = fixtures.image("lena")
        hd = np.ascontiguousarray(np.tile(lena, (3, 4, 1))[:H, :W])
        intra = IntraCodec(1.0, device=dev)
        intra.train_huffman_from_image(hd)
        IntraCodec.decode_from_container(intra.encode_to_container(hd), device=dev)
        blob = VideoCodec(1.0, codebook_policy="per-frame", device=dev).encode_to_container(y_dev)
        VideoCodec.decode_from_container(blob, return_device=True, device=dev)
    finally:
        fastvideo.decode_blocks_hot = real_hot
        intracodec.decode_blocks_device = videocodec.decode_blocks_device = real_canon
    if len(hot) != 2 or len(canon) != 1 + 1 + 8:
        raise RuntimeError(f"captured {len(hot)} hot and {len(canon)} canonical walks, "
                           f"not 2 and 10")
    # the adaptive decode walks its MV section, then frames 0..7
    return {"hot_residual": ("hot", hot[1]), "intra": ("canon", canon[0]),
            "adaptive_frame1": ("canon", canon[3])}


def bound(kind: str, args) -> tuple[float, str]:
    if kind == "hot":
        _, bits = bitpack.decode_blocks_hot_plain(*args, return_bits=True)
        return decode_walk_bound(bits.cpu().numpy(), args[0].shape[1], args[8])
    _, bits = bitpack.decode_blocks_device_plain(*args, return_bits=True)
    return canon_walk_bound(args[1].cpu().numpy(), bits.cpu().numpy(), args[0].shape[0], args[4])


def launcher(lib, kind: str, args):
    """One wrapper call on ``lib``'s build (the wrappers' checks and
    preparation, then that build's C entry)."""
    wrapper = (bitpack.decode_blocks_hot_cuda if kind == "hot"
               else bitpack.decode_blocks_device_cuda)

    def call():
        saved = bitpack._walk_lib
        bitpack._walk_lib = lambda: lib
        try:
            return wrapper(*args)
        finally:
            bitpack._walk_lib = saved
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="+",
                    help=".cu sources with decode_walk.cu's C interface")
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_ab: needs a CUDA card", file=sys.stderr)
        return 1

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60
                          ).stdout.strip().splitlines()[0]
    print(card)
    sources = {"this": cuda_build.CSRC / "decode_walk.cu"}
    for i, src in enumerate(args.others):
        sources[f"other{i}" if len(args.others) > 1 else "other"] = src
    libs = {}
    for name, src in sources.items():
        path, log = cuda_build.build_file(src.resolve())
        print(f"[{name}] {src}")
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")):
                print(f"[{name}] {line.strip()}")
        libs[name] = bitpack.bind(ctypes.CDLL(str(path)))
    others = [n for n in libs if n != "this"]
    turns = others + ["this", "this"] + others[::-1]

    dev = torch.device("cuda")
    walks = main_path_walks(dev)
    result = {"card": card, "launches": args.launches, "sources": {k: str(v) for k, v in
                                                                   sources.items()}}
    same = True
    for walk, (kind, wargs) in walks.items():
        calls = {name: launcher(lib, kind, wargs) for name, lib in libs.items()}
        plain = (bitpack.decode_blocks_hot_plain if kind == "hot"
                 else bitpack.decode_blocks_device_plain)(*wargs)
        outs = {name: fn() for name, fn in calls.items()}
        torch.cuda.synchronize()
        equal = {name: bool(torch.equal(out, plain)) for name, out in outs.items()}
        same = same and all(equal.values())
        bound_ms, bound_by = bound(kind, wargs)
        kernel = "walk_kernel" if kind == "hot" else "canon_walk_kernel"
        for fn in calls.values():
            for _ in range(3):
                fn()
        times = {name: [] for name in libs}
        for _ in range(args.rounds):
            for name in turns:
                us = kernel_device_us(calls[name], args.launches, kernel)
                times[name].append(float(np.mean(us)))
        counts = (wargs[1] if kind == "hot" else wargs[2]).clamp(0, wargs[8 if kind == "hot"
                                                                         else 4]).float()
        entry = {"kernel": kernel, "blocks": int(counts.shape[0]),
                 "LW": int(wargs[0].shape[1]) if kind == "hot" else None, "equal_to_plain": equal,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "counts_mean": float(counts.mean()), "counts_max": int(counts.max()),
                 "max_syms": int(wargs[8 if kind == "hot" else 4])}
        for name in libs:
            ms = float(np.mean(times[name])) / 1e3
            entry[name] = {"device_us": times[name], "device_ms_mean": ms,
                           "share_of_bound": bound_ms / ms}
        for name in others:
            entry[f"this_over_{name}"] = entry["this"]["device_ms_mean"] / entry[name][
                "device_ms_mean"]
        result[walk] = entry
        print(f"[ab] {walk} ({kernel}, {entry['blocks']} blocks): "
              + ", ".join(f"{name} {times[name]} us" for name in libs)
              + f" (device, mean of {args.launches} launches); bound {bound_ms * 1e3:.3f} us "
              f"({bound_by}); equal to plain {equal}; {card}")
    result["same"] = same
    print(json.dumps(result))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
