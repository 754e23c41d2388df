"""The plain reference's side of ``VideoCodec`` under per-frame codebooks: a
reader of its container (kind 3) and the frame rates under a Huffman code
of each frame's own tokens. Imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

from codec_bench import roofline
from codec_bench.reference import bitstream
from codec_bench.reference import codec as ref


def parse(blob: bytes, device, with_walks: bool = False) -> dict:
    """The container's symbols ``[T, N, 64]``, motion ``[T, hb, wb]``, each
    frame's bits under its own codebook (``frame_bits``), its tokens, a
    ``good`` flag, and with ``with_walks`` the motion walk and each frame's
    residual walk."""
    dev = torch.device(device)
    p = bitstream.parse_adaptive(blob)
    N = (p["H"] // 8) * (p["W"] // 8)
    mvs, mv_walk, good = bitstream.read_motion(p, dev, hot=False)
    if mvs is None:
        return {"good": False}
    qs, frame_bits, tokens, walks = [], [], [], [mv_walk]
    for cb, section in p["frames"]:
        toks, counts, bits, ok = bitstream.decode_section(section, cb, dev)
        toks, counts = toks[:N], counts[:N]
        blocks, okb = ref.zerorun_blocks(toks, counts, p["eob"])
        good = good and bool(ok.all()) and bool(okb.all())
        qs.append(blocks)
        frame_bits.append(ref.coded_bits(toks, counts, cb["lower"], cb["lengths"]).sum())
        tokens.append((toks, counts))
        walks.append(bitstream.walk_record(
            section, bits, roofline.out_width(int(counts.max()), roofline.CANON_CAPS), False))
    out = {"good": good, "qsyms": torch.stack(qs), "mvs": mvs,
           "frame_bits": torch.stack(frame_bits).cpu().numpy(), "tokens": tokens}
    if with_walks:
        out["walks"] = walks
    return out


def _own_code(toks: torch.Tensor, counts: torch.Tensor):
    lo, hi = ref.alphabet(*ref.token_range(toks, counts))
    return lo, ref.frame_code_lengths(ref.token_histogram(toks, counts, lo, hi))


def rates(clip: torch.Tensor, cfg: dict, device, tr: ref.Transform | None = None,
          stale: bool = False):
    """A function of a GOP's tokens giving each frame's bits under a Huffman
    code of that frame's own tokens (``stale``: every frame under frame 0's
    code, a fault)."""

    def frame_bits(tokens):
        out = []
        for toks, counts in tokens:
            lo, lens = _own_code(*(tokens[0] if stale else (toks, counts)))
            out.append(int(ref.coded_bits(toks, counts, lo, lens).sum()))
        return np.asarray(out)

    return frame_bits
