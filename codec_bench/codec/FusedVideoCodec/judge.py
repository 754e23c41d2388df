"""The plain reference's side of ``FusedVideoCodec``: a reader of its
container (kind 2), the frame rates under the reference's own fixed
hot/escape code, and the walks its round trip decodes. Imports nothing of
the program."""

from __future__ import annotations

import numpy as np
import torch

from codec_bench import roofline
from codec_bench.reference import bitstream
from codec_bench.reference import codec as ref


def parse(blob: bytes, device, with_walks: bool = False) -> dict:
    """The container's symbols ``[T, N, 64]``, motion ``[T, hb, wb]``, each
    frame's bits under its own codebook (``frame_bits``), its tokens, a
    ``good`` flag, and with ``with_walks`` the motion and residual walks."""
    dev = torch.device(device)
    p = bitstream.parse_fused(blob)
    T, H, W = p["T"], p["H"], p["W"]
    N = (H // 8) * (W // 8)
    mvs, mv_walk, good = bitstream.read_motion(p, dev, hot=True)
    if mvs is None:
        return {"good": False}
    code = p["residual_code"]
    toks, counts, bits, ok = bitstream.decode_section(p["residual"], code, dev, hot=True)
    blocks, okb = ref.zerorun_blocks(toks, counts, p["eob"])
    lens = ref.HotCode(code["lower"], code["alphabet_n"], code["hot"],
                       code["lengths"]).symbol_lengths()
    frame_bits = ref.coded_bits(toks, counts, code["lower"], lens)[:T * N].reshape(T, N).sum(1)
    out = {"good": good and bool(ok.all()) and bool(okb.all()),
           "qsyms": blocks[:T * N].reshape(T, N, 64), "mvs": mvs,
           "frame_bits": frame_bits.cpu().numpy(),
           "tokens": [(toks[t * N:(t + 1) * N], counts[t * N:(t + 1) * N]) for t in range(T)]}
    if with_walks:
        cap = roofline.out_width(int(counts.max()), roofline.HOT_CAPS)
        out["walks"] = [mv_walk, bitstream.walk_record(None, bits, cap, True)]
    return out


def rates(clip: torch.Tensor, cfg: dict, device, tr: ref.Transform | None = None,
          stale: bool = False):
    """A function of a GOP's tokens giving each frame's bits under the
    reference's own hot/escape code, trained as the configuration says on
    the clip's first two frames (``stale``: on the first alone, a fault)."""
    dev = torch.device(device)
    tr = tr or ref.Transform(cfg["q"], dev)
    code = ref.train_fused_code(clip[:1 if stale else 2].to(dev), tr, cfg["sr"])
    lens = code.symbol_lengths()
    return lambda tokens: np.asarray(
        [int(ref.coded_bits(t, c, code.lower, lens).sum()) for t, c in tokens])


def reference_walks(cfg: dict, info: dict, gops: list[torch.Tensor], clip: torch.Tensor,
                    device) -> dict:
    """Per clip GOP, the one residual walk ``decode_gop`` launches, from the
    reference's own coding of the GOP, at the output width the program
    packed with (``info["cap"]``)."""
    dev = torch.device(device)
    tr = ref.Transform(cfg["q"], dev)
    code = ref.train_fused_code(clip[:2].to(dev), tr, cfg["sr"])
    lens = code.symbol_lengths()
    out = {}
    for g, frames in enumerate(gops):
        qsyms, _, _ = ref.encode_gop(frames.to(dev), tr, cfg["sr"])
        toks, counts = ref.zerorun_tokens(qsyms.reshape(-1, 64))
        bits = ref.coded_bits(toks, counts, code.lower, lens)
        out[g] = [bitstream.walk_record(None, bits, info["cap"], True)]
    return out
