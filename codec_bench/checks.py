"""What decides ``correct``, and the work the walk rooflines count: the plain
reference (``codec_bench/reference``) run over what the window produced,
once the window has closed and the program is freed.

The reference reads the program's outputs only to judge them: the symbols,
motion and decoded frames a round trip returned, and containers through
the configuration's codec judge (``codec/<codec>/judge.py``: a plain reader
of its bytes, and the frame rates under the reference's own codebooks).

A judge that defines ``NUMBERS`` (the names it reads) and ``numbers(src,
entry, parsed, cfg, device)`` (their readings for one kept unit) owns its
check: the harness takes the worst of each over the kept units. Any other
judge is a luma GOP codec's, judged by the four numbers of ``VIDEO``.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from codec_bench.reference import judge as numbers
from codec_bench.reference import codec as ref

VIDEO = ("me_gap", "quant_excess", "recon_gap", "rate_gap")
BROKEN = dict.fromkeys(VIDEO, math.inf)


def parse(judge, blob: bytes, device, with_walks: bool = False) -> dict:
    """``judge.parse``, with bytes that the container's layout cannot hold
    read as a broken container."""
    try:
        return judge.parse(blob, device, with_walks)
    except (ValueError, IndexError, RuntimeError, struct.error):
        return {"good": False}


def judge_kept(judge, kept: list[dict], gops: list[torch.Tensor], blobs: list[bytes] | None,
               cfg: dict, clip: torch.Tensor, device) -> dict:
    """The worst reading of every number over the GOPs kept from the window.

    Each kept GOP holds ``gop`` (its index in the clip), ``recons`` (the
    frames the program decoded) and either the round trip's ``qsyms``,
    ``mvs`` and ``totals`` (per-frame bits), its container ``blob``, or
    nothing more (the container is the set-up's, ``blobs[gop]``). A judge
    that owns its numbers reads each kept GOP as it is, with its parsed
    container where it has one."""
    dev = torch.device(device)
    if hasattr(judge, "NUMBERS"):
        return _own_numbers(judge, kept, gops, blobs, cfg, dev)
    tr = ref.Transform(cfg["q"], dev)
    rates = judge.rates(clip, cfg, dev)
    readings = []
    for k in kept:
        src = gops[k["gop"]].to(dev)
        decoded = torch.as_tensor(k["recons"]).to(dev)
        if "qsyms" in k:
            qsyms = torch.as_tensor(k["qsyms"]).to(dev).to(torch.int64)
            mvs = torch.as_tensor(k["mvs"]).to(dev).to(torch.int64)
            tokens = [ref.zerorun_tokens(qsyms[t]) for t in range(qsyms.shape[0])]
            program_bits = np.asarray(k["totals"], dtype=np.int64)
        else:
            parsed = parse(judge, k["blob"] if "blob" in k else blobs[k["gop"]], dev)
            if not parsed["good"]:
                readings.append(dict(BROKEN))
                continue
            qsyms, mvs, tokens = parsed["qsyms"], parsed["mvs"], parsed["tokens"]
            program_bits = parsed["frame_bits"]
        nums = numbers.gop_numbers(src, qsyms, mvs, decoded, tr, cfg["sr"])
        nums["rate_gap"] = numbers.rate_gap(program_bits, rates(tokens))
        readings.append(nums)
    return numbers.worst(readings)


def _own_numbers(judge, kept, units, blobs, cfg, dev) -> dict:
    """The worst of each of ``judge.NUMBERS`` over the kept units; a unit
    whose container cannot be parsed, or a name the judge leaves out,
    reads inf."""
    readings = []
    for k in kept:
        blob = k["blob"] if "blob" in k else blobs[k["gop"]] if blobs else None
        parsed = None if blob is None else parse(judge, blob, dev)
        if parsed is not None and not parsed["good"]:
            nums = {}
        else:
            nums = judge.numbers(units[k["gop"]].to(dev), k, parsed, cfg, dev)
        readings.append({n: nums.get(n, math.inf) for n in judge.NUMBERS})
    return numbers.worst(readings)


def walk_work(judge, cfg: dict, info: dict, gops: list[torch.Tensor], blobs: dict,
              clip: torch.Tensor, device) -> dict:
    """Per clip GOP, the walks one GOP's decode launches, in launch order:
    ``{gop: [walk, ...]}``. From the containers where the window decoded
    containers (``blobs``: clip GOP -> bytes), else from the judge's own
    coding of the clip (``judge.reference_walks``, given the last step's
    ``info``); ``{}`` where neither exists."""
    dev = torch.device(device)
    if blobs:
        return {g: parse(judge, b, dev, with_walks=True).get("walks", [])
                for g, b in blobs.items()}
    if hasattr(judge, "reference_walks"):
        return judge.reference_walks(cfg, info, gops, clip, dev)
    return {}
