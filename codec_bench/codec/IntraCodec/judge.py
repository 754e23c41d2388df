"""The plain reference's side of ``IntraCodec``: a reader of its IVC1 intra
container and a judge that owns its numbers and its control
(``reference/intra.py``). Imports nothing of the program.

- ``quant_excess``: transform and quantiser. How far beyond half a step
  any symbol of the container lies from the reference's float64
  coefficient of its plane under that plane's table, in quantiser steps.
  A symbol the program clamped to its alphabet's edge reads here.
- ``recon_gap``: the decode. The largest difference, in levels, between
  the RGB image the program decoded and the reference's decoder chain run
  on the container's symbols.
- ``rate_gap``: the entropy coder. The share by which the container's
  bits differ from the bits of its tokens under the reference's own code,
  trained the course's way over the full alphabet
  (``intra.full_alphabet``) on the image the program trained its code on
  (the kept output's ``trained_on``: the clip's first image), so that
  coding one image under another's code reads as no fault.
"""

from __future__ import annotations

import math

import torch

from codec_bench.reference import codec as ref
from codec_bench.reference import intra
from codec_bench.reference import judge as numbers_of

NUMBERS = ("quant_excess", "recon_gap", "rate_gap")
# the stale codebook of the control: trained at the course's RD sweep's
# previous point (q 0.1 before q 0.15), left in place at the next
STALE_Q = 2.0 / 3.0


def parse(blob: bytes, device, with_walks: bool = False) -> dict:
    """The container's symbols ``[3, N, 64]``, tokens, counts and bits, a
    ``good`` flag, and with ``with_walks`` the one canonical walk its decode
    launches."""
    out = intra.read_container(blob, device)
    walk = out.pop("walk")
    if with_walks:
        out["walks"] = [walk]
    return out


def numbers(src: torch.Tensor, entry: dict, parsed, cfg: dict, device) -> dict:
    """The three numbers of one kept image ``src`` ``[H, W, 3]``: from its
    parsed container where the program made one, else from ``entry``'s
    symbols ``qsyms`` ``[3, N, 64]`` and ``bits``; ``entry["recons"]`` is
    the RGB image decoded, ``entry["trained_on"]`` the RGB image the code
    was trained on (without it ``rate_gap`` is left out, so reads inf)."""
    dev = torch.device(device)
    codec = intra.Intra(cfg["q"], dev)
    planes = intra.to_ycc(src.to(dev))
    _, H, W = planes.shape
    if parsed is not None:
        qsyms, toks, counts = parsed["qsyms"], parsed["tokens"], parsed["counts"]
        bits = parsed["bits"]
    else:
        qsyms = torch.as_tensor(entry["qsyms"]).to(dev).to(torch.int64)
        toks, counts = ref.zerorun_tokens(intra.interleave(qsyms))
        bits = int(entry["bits"])
    scaled = codec.coefficients(planes) / codec.qt[:, None]
    excess = float(((scaled - qsyms.to(torch.float64)).abs() - 0.5).max().clamp_min(0))
    chain = intra.to_rgb(codec.reconstruct(qsyms, H, W))
    decoded = torch.as_tensor(entry["recons"]).to(dev).to(torch.float64)
    gap = float((decoded - chain).abs().max()) if decoded.shape == chain.shape else math.inf
    out = {"quant_excess": excess, "recon_gap": gap}
    if entry.get("trained_on") is not None:
        trained = torch.as_tensor(entry["trained_on"]).to(dev)
        lo, lengths = intra.train_code(codec.quantise(intra.to_ycc(trained)),
                                       intra.full_alphabet(cfg["q"]))
        own = int(ref.coded_bits(toks, counts, lo, lengths).sum())
        out["rate_gap"] = numbers_of.rate_gap([bits], [own])
    return out


def control(kind: str, cell, units: list[torch.Tensor], clip: torch.Tensor, picks: list[int],
            device) -> list[dict]:
    """The reference in the program's place on the picked images, its
    codebook trained once on the clip's first image over the full alphabet
    as the program's is:

    - ``control``: the coder and decoder one precision below the
      configuration's float32 (TF32 transforms);
    - ``encoder``: the TF32 coder, the full-precision decoder;
    - ``luma_table``: full precision, Cb and Cr dequantised with the
      luminance table;
    - ``stale_code``: full precision, the codebook trained at ``STALE_Q``
      times the configuration's ``q``, over that ``q``'s alphabet.
    """
    dev = torch.device(device)
    q = cell.cfg["q"]
    low = kind in ("control", "encoder")
    coder = intra.Intra(q, dev, ref.tf32_matmul if low else ref.f64_matmul)
    decoder = intra.Intra(q, dev, ref.tf32_matmul if kind == "control" else ref.f64_matmul,
                          chroma_table=kind != "luma_table")
    q_trained = q * STALE_Q if kind == "stale_code" else q
    trainer = intra.Intra(q_trained, dev) if kind == "stale_code" else coder
    code = intra.train_code(trainer.quantise(intra.to_ycc(clip[0].to(dev))),
                            intra.full_alphabet(q_trained))
    kept = []
    for g in picks:
        qsyms = coder.quantise(intra.to_ycc(units[g].to(dev)))
        H, W = units[g].shape[:2]
        kept.append({"gop": g, "qsyms": qsyms, "bits": intra.image_bits(qsyms, code),
                     "recons": intra.to_rgb(decoder.reconstruct(qsyms, H, W)),
                     "trained_on": clip[0]})
    return kept
