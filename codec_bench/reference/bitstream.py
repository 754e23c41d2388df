"""Plain reader of the two IVC1 video containers the benchmark judges.

The wire layout (all little-endian), as the port's container documentation
states it:

- header ``<4sHBBfiIIIQ``: magic ``IVC1``, version, kind (2 = fixed-codebook
  GOP, 3 = per-frame adaptive GOP), policy flag, q, EOB, T, H, W, payload
  bits; then the search range ``<B`` and ``T`` u64 per-frame bits;
- kind 2: the residual and the motion hot/escape codebooks (``<iIH`` lower
  bound, alphabet size, K; K u32 hot alphabet indices; K + 1 u8 lengths,
  the last the escape's), the residual section, the motion section;
- kind 3: the motion codebook (``<iI`` lower bound, n; n u8 lengths), the
  motion section, then per frame its codebook and its residual section;
- a grouped section ``<HIQ``-like head ``<HIIQ`` (group size, words per
  group, groups, blocks), the groups' used word counts (u32), each block's
  bit offset in its group (u16) and symbol count (u8), then each group's
  used u32 words back to back. Codes run MSB first through each group.

A block's symbols are canonical codes of the section's codebook; under a
hot/escape code the escape is followed by the alphabet index on
``ceil(log2(alphabet size))`` bits. Symbols are alphabet indices plus the
codebook's lower bound. Motion sections are 64-symbol blocks of the packed
motion indices of frames 1..T-1.

Decoding walks every block of a section at once, one symbol a step, in
plain PyTorch on the device the caller names.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from codec_bench import roofline
from codec_bench.reference.codec import canonical_code

MASK32 = (1 << 32) - 1


class _Cursor:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.off = 0

    def take(self, fmt: str):
        out = struct.unpack_from(fmt, self.data, self.off)
        self.off += struct.calcsize(fmt)
        return out

    def array(self, dtype: str, n: int) -> np.ndarray:
        dt = np.dtype(dtype)
        if self.off + n * dt.itemsize > len(self.data):
            raise ValueError("container truncated")
        out = np.frombuffer(self.data, dtype=dt, count=n, offset=self.off).copy()
        self.off += n * dt.itemsize
        return out


def _section(c: _Cursor) -> dict:
    group_size, wpg, n_groups, n_blocks = c.take("<HIIQ")
    used = c.array("<u4", n_groups).astype(np.int64)
    offs = c.array("<u2", n_blocks).astype(np.int64)
    counts = c.array("u1", n_blocks).astype(np.int64)
    words = c.array("<u4", int(used.sum())).astype(np.int64)
    group_start = np.concatenate([[0], np.cumsum(used)[:-1]])
    return {"group_size": group_size, "words_per_group": wpg, "words": words, "group_words": used,
            "starts": np.repeat(group_start * 32, group_size) + offs, "counts": counts,
            "in_group": offs}


def _header(c: _Cursor, kind: int) -> dict:
    magic, version, k, policy, q, eob, T, H, W, bits = c.take("<4sHBBfiIIIQ")
    if magic != b"IVC1" or version != 1 or k != kind:
        raise ValueError(f"not an IVC1 kind-{kind} container")
    (sr,) = c.take("<B")
    frame_bits = c.array("<u8", T).astype(np.int64)
    return {"q": q, "eob": eob, "T": T, "H": H, "W": W, "sr": sr, "policy": policy,
            "payload_bits": bits, "frame_bits": frame_bits}


def _hot_codebook(c: _Cursor) -> dict:
    lower, alphabet_n, k = c.take("<iIH")
    hot = c.array("<u4", k).astype(np.int64)
    lengths = c.array("u1", k + 1).astype(np.int64)
    return {"lower": lower, "alphabet_n": alphabet_n, "hot": hot, "lengths": lengths,
            "raw_bits": max(math.ceil(math.log2(max(alphabet_n, 2))), 1)}


def _codebook(c: _Cursor) -> dict:
    lower, n = c.take("<iI")
    return {"lower": lower, "lengths": c.array("u1", n).astype(np.int64)}


def parse_fused(blob: bytes) -> dict:
    """Kind 2: header, residual and motion hot codebooks and sections."""
    c = _Cursor(blob)
    out = _header(c, 2)
    out["residual_code"] = _hot_codebook(c)
    out["mv_code"] = _hot_codebook(c)
    out["residual"] = _section(c)
    out["mv"] = _section(c)
    return out


def parse_adaptive(blob: bytes) -> dict:
    """Kind 3: header, motion codebook and section, per-frame codebooks and
    sections."""
    c = _Cursor(blob)
    out = _header(c, 3)
    out["mv_code"] = _codebook(c)
    out["mv"] = _section(c)
    out["frames"] = [(_codebook(c), _section(c)) for _ in range(out["T"])]
    return out


def decode_section(section: dict, code: dict, device, hot: bool = False):
    """Every block's symbols of a section under a canonical (``hot=False``,
    ``code`` from :func:`_codebook`) or hot/escape code.

    Returns (symbols ``[B, max count]`` int64, counts ``[B]``, bits each
    block walked ``[B]``, ``[B]`` bool: every code of the block was valid
    and it stayed inside its group's words).
    """
    dev = torch.device(device)
    words = torch.as_tensor(np.concatenate([section["words"], [0, 0]]), dtype=torch.int64,
                            device=dev)
    pos = torch.as_tensor(section["starts"], dtype=torch.int64, device=dev)
    counts = torch.as_tensor(section["counts"], dtype=torch.int64, device=dev)
    start = pos.clone()
    gs = section["group_size"]
    g_end = np.repeat((np.cumsum(section["group_words"])) * 32, gs)
    limit = torch.as_tensor(g_end, dtype=torch.int64, device=dev)
    n_words = words.numel() - 2

    cc = canonical_code(code["lengths"])
    first = torch.as_tensor(cc["first"], device=dev)
    cnt = torch.as_tensor(cc["count"], device=dev)
    begin = torch.as_tensor(cc["start"], device=dev)
    ranked = torch.as_tensor(cc["ranked"], device=dev)
    K = code["lengths"].size - 1
    hot_values = torch.as_tensor(code["hot"], device=dev) if hot else None

    def peek(p):
        w = (p >> 5).clamp(0, n_words)
        sh = p & 31
        both = (words[w] << 32) | words[w + 1]
        return (both >> (32 - sh)) & MASK32

    B = pos.numel()
    S = int(counts.max()) if B else 0
    syms = torch.zeros((B, max(S, 1)), dtype=torch.int64, device=dev)
    good = torch.ones(B, dtype=torch.bool, device=dev)
    for j in range(S):
        active = counts > j
        window = peek(pos)
        found = torch.zeros(B, dtype=torch.bool, device=dev)
        slot = torch.zeros(B, dtype=torch.int64, device=dev)
        length = torch.zeros(B, dtype=torch.int64, device=dev)
        for L in range(cc["min_len"], cc["max_len"] + 1):
            if cc["count"][L] == 0:
                continue
            k = (window >> (32 - L)) - first[L]
            hit = ~found & (k >= 0) & (k < cnt[L])
            slot = torch.where(hit, ranked[(begin[L] + k).clamp(0, ranked.numel() - 1)], slot)
            length = torch.where(hit, L, length)
            found |= hit
        good &= found | ~active
        pos = pos + torch.where(active, length, 0)
        if hot:
            raw_bits = code["raw_bits"]
            esc = active & (slot == K)
            raw = peek(pos) >> (32 - raw_bits)
            value = torch.where(esc, raw, hot_values[slot.clamp(0, max(K - 1, 0))])
            pos = pos + torch.where(esc, raw_bits, 0)
        else:
            value = slot
        syms[:, j] = torch.where(active, value + code["lower"], 0)
    good &= pos <= limit
    return syms, counts, pos - start, good


def read_motion(p: dict, device, hot: bool):
    """A parsed container's motion ``[T, hb, wb]`` (frame 0 all zero
    vectors), the motion walk's record and whether every block decoded;
    ``None`` for the motion where the section holds too few symbols."""
    dev = torch.device(device)
    T, H, W, sr = p["T"], p["H"], p["W"], p["sr"]
    hb, wb = H // 8, W // 8
    syms, _, bits, ok = decode_section(p["mv"], p["mv_code"], dev, hot=hot)
    flat = syms[:, :64].reshape(-1)
    M = (T - 1) * hb * wb
    if flat.numel() < M:
        return None, None, False
    mvs = torch.cat([torch.full((1, hb, wb), sr * (2 * sr + 1) + sr, dtype=torch.int64,
                                device=dev), flat[:M].reshape(T - 1, hb, wb)])
    return mvs, walk_record(p["mv"], bits, 64, hot), bool(ok.all())


def walk_record(section: dict | None, bits: torch.Tensor, max_syms: int, hot: bool) -> dict:
    """What one decode walk reads, for its roofline: each block's bits
    walked (from the reference's own walk), the width of the output it
    writes and, for a canonical walk, each block's offset in ``section``'s
    words."""
    b = bits.cpu().numpy()
    if hot:
        return {"kind": "hot", "block_bits": b, "LW": roofline.row_words(b), "max_syms": max_syms}
    wpg = section["words_per_group"]
    return {"kind": "canon", "block_bits": b, "max_syms": max_syms,
            "offsets": np.repeat(np.arange(section["group_words"].size) * wpg * 32,
                                 section["group_size"]) + section["in_group"],
            "n_words": section["group_words"].size * wpg}
