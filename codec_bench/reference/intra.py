"""Plain reference of the course's still-image intra codec and a reader of
its IVC1 container.

Written from the published description of the lab's ``IntraCodec``
(``ivclab/image/intracodec.py``: JPEG's mathematics on three 4:4:4 planes,
one Huffman code over all of them), of JFIF's colour conversion (ITU-T
T.871 section 7) and of JPEG (ITU-T T.81: the 8x8 DCT-II, the zig-zag
scan, Annex K's tables), in plain PyTorch and NumPy, float64 on whatever
device the tensors live on. It imports nothing of the program; the
transform, the scan, the zero-run and the Huffman code lengths come from
``reference/codec.py`` and the container's sections are walked by
``reference/bitstream.py``.

The codec: RGB to YCbCr (JFIF, chroma offset 128); every plane cut into
8x8 blocks in raster order; the orthonormal 2-D DCT-II in scan order; Y
divided by Annex K's luminance table and Cb, Cr by its chrominance table,
each scaled by ``q`` (float32 values), rounded half to even; each block
zero-run coded (every nonzero value up to the last one as itself, every
run of zeros before it as ``0, run``, then the EOB symbol 4000); one
Huffman code trained on every block's tokens of one image: the trained
range widened by 20 and rounded out to multiples of 64, the smoothed pmf
(frequencies plus 1e-9, renormalised), Huffman code lengths limited to 26
bits, the canonical code. The decoder runs it backwards: dequantise,
inverse DCT, YCbCr to RGB by T.871's inverse, clipped to [0, 255].

Departures from the course's ``IntraCodec``, each also the program's:

- the symbol count travels in the container (the course keeps it on the
  codec object as ``num_symbols``);
- the training range is rounded out to multiples of 64 around the
  course's +-20 margin;
- the alphabet may be fixed in advance (``full_alphabet``: every symbol
  an 8-bit RGB image can produce, widened and rounded out as a trained
  range is) instead of the training image's range, outside which the
  course's code has no code for another image's symbol;
- the chrominance table is the course's: Annex K's table K.2 with 13 in
  place of 26 at row 2, column 1;
- dequantisation truncates toward zero the product of a symbol and its
  step rounded to float32 (the JAX package's float32 arithmetic): in
  float64, 20 x f32(17 x 0.15) lies just below 51 and truncates to 50;
- the blocks of the three planes interleave in the container, block
  position by block position, Y then Cb then Cr; the container pads the
  blocks to a multiple of its group size (16) with empty blocks;
- only frames whose sides are multiples of 8 are read here (the program
  repeats the last row and column to pad others).
"""

from __future__ import annotations

import numpy as np
import torch

from codec_bench import roofline
from codec_bench.reference import bitstream
from codec_bench.reference import codec as ref

KIND_INTRA = 0
LAYOUT_GROUPED = 1

# The course's chrominance table: ITU-T T.81 Annex K.1, table K.2, with 13
# in place of 26 at row 2, column 1.
CHROMA = np.array([[17, 18, 24, 47] + [99] * 4, [18, 21, 26, 66] + [99] * 4,
                   [24, 13, 56] + [99] * 5, [47, 66] + [99] * 6] + [[99] * 8] * 4,
                  dtype=np.float64)
# JFIF RGB -> YCbCr, then + (0, 128, 128); and T.871's inverse
RGB_TO_YCC = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]])
YCC_TO_RGB = np.array([[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]])
OFFSET = np.array([0.0, 128.0, 128.0])


def tables(q: float, chroma_table: bool = True) -> np.ndarray:
    """``[3, 64]`` scan-ordered steps of Y, Cb and Cr scaled by ``q`` (float32
    values): the luminance table for Y, the chrominance table for Cb and Cr
    (``chroma_table=False``: the luminance table for all three, a fault)."""
    chroma = CHROMA if chroma_table else ref.JPEG_LUMA
    scan = ref.zigzag()
    rows = [ref.JPEG_LUMA, chroma, chroma]
    return np.stack([(t.astype(np.float32) * np.float32(q)).reshape(-1)[scan] for t in rows]
                    ).astype(np.float64)


def to_ycc(image: torch.Tensor) -> torch.Tensor:
    """``[H, W, 3]`` RGB -> ``[3, H, W]`` float64 YCbCr planes."""
    m = torch.tensor(RGB_TO_YCC, dtype=torch.float64, device=image.device)
    off = torch.tensor(OFFSET, dtype=torch.float64, device=image.device)
    return torch.einsum("cx,hwx->chw", m, image.to(torch.float64)) + off[:, None, None]


def to_rgb(planes: torch.Tensor) -> torch.Tensor:
    """``[3, H, W]`` YCbCr planes -> ``[H, W, 3]`` RGB clipped to [0, 255]."""
    m = torch.tensor(YCC_TO_RGB, dtype=torch.float64, device=planes.device)
    off = torch.tensor(OFFSET, dtype=torch.float64, device=planes.device)
    return torch.einsum("xc,chw->hwx", m, planes - off[:, None, None]).clamp(0, 255)


class Intra:
    """The codec's transform and quantiser of three planes on one device;
    ``matmul`` selects the precision of both transforms."""

    def __init__(self, q: float, device, matmul=ref.f64_matmul, chroma_table: bool = True):
        F = ref.forward_matrix()
        self.fwd_t = torch.tensor(F.T, dtype=torch.float64, device=device)
        self.inv_t = torch.tensor(F, dtype=torch.float64, device=device)
        self.qt = torch.tensor(tables(q, chroma_table), dtype=torch.float64, device=device)
        self.matmul = matmul

    def coefficients(self, planes: torch.Tensor) -> torch.Tensor:
        """``[3, H, W]`` -> scan-ordered coefficients ``[3, N, 64]``."""
        return torch.stack([self.matmul(ref.to_blocks(p), self.fwd_t) for p in planes])

    def quantise(self, planes: torch.Tensor) -> torch.Tensor:
        """``[3, H, W]`` -> symbols ``[3, N, 64]`` int64 (round half even)."""
        return torch.round(self.coefficients(planes) / self.qt[:, None]).to(torch.int64)

    def reconstruct(self, qsyms: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """Symbols ``[3, N, 64]`` -> YCbCr planes ``[3, H, W]``."""
        step = self.qt.to(torch.float32)[:, None]
        deq = torch.trunc(qsyms.to(torch.float32) * step).to(torch.float64)
        return torch.stack([ref.from_blocks(self.matmul(d, self.inv_t), H, W) for d in deq])


def interleave(qsyms: torch.Tensor) -> torch.Tensor:
    """``[3, N, 64]`` planes' blocks -> ``[3 N, 64]`` in the container's
    order (block position by position, Y, Cb, Cr)."""
    return qsyms.permute(1, 0, 2).reshape(-1, 64)


def full_alphabet(q: float) -> tuple[int, int]:
    """The alphabet ``[lo, hi)`` around every symbol an RGB image of levels
    in [0, 255] can produce at ``q``: each plane's YCbCr range over the RGB
    cube, through the positive and the negative part of each basis
    function, over the plane's step; with the zero-run's symbols (runs
    below 64, the EOB), widened and rounded out as a trained range is."""
    m = RGB_TO_YCC
    lo_px = np.minimum(m, 0).sum(1) * 255 + OFFSET
    hi_px = np.maximum(m, 0).sum(1) * 255 + OFFSET
    F = ref.forward_matrix()
    pos, neg = np.clip(F, 0, None).sum(1), np.clip(F, None, 0).sum(1)
    steps = tables(q)
    top = (pos * hi_px[:, None] + neg * lo_px[:, None]) / steps
    bottom = (pos * lo_px[:, None] + neg * hi_px[:, None]) / steps
    return ref.alphabet(min(int(np.floor(bottom.min())), 0),
                        max(int(np.ceil(top.max())), ref.EOB, 64))


def train_code(qsyms: torch.Tensor, bounds: tuple[int, int] | None = None
               ) -> tuple[int, np.ndarray]:
    """The course's codebook of one image's symbols ``[3, N, 64]``: (the
    alphabet's lower bound, every symbol's code length). The alphabet is
    the trained range's, or ``bounds`` ``[lo, hi)`` where given."""
    toks, counts = ref.zerorun_tokens(interleave(qsyms))
    lo, hi = bounds if bounds is not None else ref.alphabet(*ref.token_range(toks, counts))
    return lo, ref.frame_code_lengths(ref.token_histogram(toks, counts, lo, hi))


def image_bits(qsyms: torch.Tensor, code: tuple[int, np.ndarray]) -> int:
    """Bits of one image's symbols ``[3, N, 64]`` under ``code``."""
    toks, counts = ref.zerorun_tokens(interleave(qsyms))
    return int(ref.coded_bits(toks, counts, code[0], code[1]).sum())


def parse_container(blob: bytes) -> dict:
    """Header, codebook and grouped section of an IVC1 intra container (kind
    0, grouped layout); raises ``ValueError`` on another."""
    c = bitstream._Cursor(blob)
    magic, version, kind, layout, q, eob, H, W, C, n_symbols, bits = c.take("<4sHBBfiIIIQQ")
    if magic != b"IVC1" or version != 1 or kind != KIND_INTRA or layout != LAYOUT_GROUPED:
        raise ValueError("not an IVC1 intra container in the grouped layout")
    if C != 3 or H % 8 or W % 8:
        raise ValueError(f"not a three-plane image of whole blocks: ({H}, {W}, {C})")
    return {"q": q, "eob": eob, "H": H, "W": W, "n_symbols": n_symbols, "payload_bits": bits,
            "code": bitstream._codebook(c), "section": bitstream._section(c)}


def read_container(blob: bytes, device) -> dict:
    """A container's symbols ``[3, N, 64]``, its tokens and counts in its
    block order, its payload bits (the codes its blocks walk), the walk's
    record for the roofline, and ``good``: every code valid, every block
    inside its group and ending at its EOB, the padding blocks empty, and
    the header's symbol count and payload bits those of the section."""
    dev = torch.device(device)
    p = parse_container(blob)
    n = 3 * (p["H"] // 8) * (p["W"] // 8)
    section = p["section"]
    if section["counts"].size < n:
        raise ValueError("the section holds fewer blocks than the image needs")
    toks, counts, bits, ok = bitstream.decode_section(section, p["code"], dev)
    blocks, well_formed = ref.zerorun_blocks(toks[:n], counts[:n], p["eob"])
    walked = int(bits.sum())
    good = (bool(ok.all()) and bool(well_formed.all()) and int(counts[n:].sum()) == 0
            and walked == p["payload_bits"] and int(counts.sum()) == p["n_symbols"])
    width = roofline.out_width(int(counts.max()), roofline.CANON_CAPS)
    return {"good": good, "H": p["H"], "W": p["W"],
            "qsyms": blocks.reshape(n // 3, 3, 64).permute(1, 0, 2),
            "tokens": toks[:n], "counts": counts[:n], "bits": walked,
            "walk": bitstream.walk_record(section, bits, width, False)}
