"""IVC1 bitstream container: the fused GOP codec's wire format.

Port of the video-GOP part of ``ivclab_tpu/runtime/container.py``. The
bytes are identical to the JAX package's; a blob written by either side
parses on the other.

  header      magic, version, kind=KIND_VIDEO_GOP, quantization scale, EOB,
              T/H/W, payload bit count, search range, per-frame bits
  codebooks   residual + motion-vector hot/escape codes (lower bound,
              alphabet size, hot alphabet indices, canonical lengths)
  sections    the grouped residual stream and the grouped MV stream:
              word-aligned per-group substreams plus the per-block sidecar
              (u16 in-group bit offset + u8 symbol count) that lets every
              block decode independently

Parsing treats the bytes as hostile: every count is bounds-checked before
anything is allocated, and every failure is a ``ValueError``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

MAGIC = b"IVC1"
VERSION = 1
KIND_VIDEO_GOP = 2

# The u16 in-group bit-offset sidecar bounds a group substream to 2048 words.
MAX_WORDS_PER_GROUP = 2048
MAX_DIM = 1 << 16          # H/W/T sanity bound
MAX_CODEBOOK = 1 << 20     # alphabet size bound


class _Reader:
    """Bounds-checked cursor over untrusted container bytes.

    A truncated, bit-flipped or hostile blob raises ``ValueError``, and a
    wire-supplied count never allocates beyond the bytes present.
    """

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.off = 0

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        if self.off + size > len(self.buf):
            raise ValueError("truncated IVC1 container (header)")
        out = struct.unpack_from(fmt, self.buf, self.off)
        self.off += size
        return out

    def array(self, dtype, count: int, what: str) -> np.ndarray:
        count = int(count)
        itemsize = np.dtype(dtype).itemsize
        if count < 0 or self.off + count * itemsize > len(self.buf):
            raise ValueError(f"truncated IVC1 container ({what})")
        out = np.frombuffer(self.buf, dtype=dtype, count=count, offset=self.off).copy()
        self.off += count * itemsize
        return out


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class HotCodebook:
    """Transmissible form of a hot/escape code (see ``codebook.HotCode``):
    hot alphabet indices + canonical lengths (K hot + trailing ESCAPE)."""

    lower_bound: int
    alphabet_n: int
    hot_values: np.ndarray  # [K] int32
    lengths: np.ndarray  # [K+1] uint8

    def to_bytes(self) -> bytes:
        hv = self.hot_values.astype("<u4")
        return (
            struct.pack("<iIH", self.lower_bound, self.alphabet_n, hv.size)
            + hv.tobytes()
            + self.lengths.astype(np.uint8).tobytes()
        )

    @classmethod
    def from_buffer(cls, r: _Reader):
        lower, an, k = r.unpack("<iIH")
        if an > MAX_CODEBOOK:
            raise ValueError(f"alphabet size {an} exceeds the format bound")
        hv = r.array("<u4", k, "hot values").astype(np.int32)
        lengths = r.array(np.uint8, k + 1, "hot lengths")
        return cls(lower, an, hv, lengths)

    @classmethod
    def from_code(cls, code):
        return cls(
            lower_bound=code.lower_bound,
            alphabet_n=code.alphabet_n,
            hot_values=np.asarray(code.hot_values, dtype=np.int32),
            lengths=np.asarray(code.code.lengths, dtype=np.uint8),
        )

    def to_code(self):
        from ivclab_tpu_torch.entropy.codebook import hot_code_from_parts

        return hot_code_from_parts(
            self.lower_bound, self.alphabet_n, self.hot_values,
            self.lengths.astype(np.int32),
        )


@dataclass
class GroupedSection:
    """One grouped bitstream: word-aligned per-group substreams + the
    per-block sidecar (u16 in-group bit offset, u8 symbol count). The words
    are stored compacted (only each group's used words)."""

    words: np.ndarray  # [G, words_per_group] u32 (zero-padded tail)
    group_word_counts: np.ndarray  # [G] u32
    block_offsets: np.ndarray  # [B] u16, in-group bit offsets
    block_counts: np.ndarray  # [B] u8
    group_size: int
    words_per_group: int

    def to_bytes(self) -> bytes:
        gwc = self.group_word_counts.astype("<u4")
        head = struct.pack(
            "<HIIQ", self.group_size, self.words_per_group, gwc.size, self.block_offsets.size
        )
        parts = [head, gwc.tobytes(), self.block_offsets.astype("<u2").tobytes(),
                 self.block_counts.astype(np.uint8).tobytes()]
        used = self.words.reshape(gwc.size, self.words_per_group)
        mask = np.arange(self.words_per_group)[None, :] < gwc[:, None]
        parts.append(used[mask].astype("<u4").tobytes())
        return b"".join(parts)

    @classmethod
    def from_buffer(cls, r: _Reader):
        group_size, wpg, n_groups, n_blocks = r.unpack("<HIIQ")
        if group_size < 1:
            raise ValueError("grouped section: group_size must be >= 1")
        if not 1 <= wpg <= MAX_WORDS_PER_GROUP:
            raise ValueError(
                f"grouped section: words_per_group {wpg} outside "
                f"[1, {MAX_WORDS_PER_GROUP}]"
            )
        if n_blocks != n_groups * group_size:
            raise ValueError(
                "grouped section: sidecar size does not match "
                f"{n_groups} groups x {group_size} blocks"
            )
        # decoder allocation cap: the word buffer materializes as
        # [n_groups, wpg] even when most groups are short, so bound it by an
        # absolute ceiling (128 MB) and, past a 16 MB floor, by 32x the blob
        # size; a hostile (n_groups, wpg) pair with all-zero word counts
        # would otherwise pass every byte-level check while demanding
        # gigabytes.
        alloc = n_groups * wpg * 4
        if alloc > (1 << 27) or (alloc > (1 << 24) and alloc > 32 * len(r.buf)):
            raise ValueError(
                f"grouped section: {n_groups} groups x {wpg} words exceeds "
                "the decoder allocation cap"
            )
        gwc = r.array("<u4", n_groups, "group word counts")
        if gwc.size and int(gwc.max()) > wpg:
            raise ValueError("grouped section: group word count exceeds stride")
        boffs = r.array("<u2", n_blocks, "block offsets")
        bcnts = r.array(np.uint8, n_blocks, "block counts")
        flat = r.array("<u4", int(gwc.sum()), "group words")
        words = np.zeros((n_groups, wpg), dtype=np.uint32)
        mask = np.arange(wpg)[None, :] < gwc[:, None]
        words[mask] = flat
        return cls(words, gwc, boffs, bcnts, group_size, wpg)

    @classmethod
    def from_device(cls, group_words, group_bits, block_offsets, block_counts,
                    group_size: int, words_per_group: int):
        """Assemble from the packer outputs (tensors or arrays).

        ``group_words`` holds 32-bit words (int64 tensors are masked words);
        ``block_offsets`` are bit offsets into the flattened stream.
        """
        group_words = _numpy(group_words).reshape(-1, words_per_group).astype(np.uint32)
        group_bits = _numpy(group_bits).reshape(-1).astype(np.int64)
        gwc = ((group_bits + 31) // 32).astype(np.uint32)
        base = np.arange(group_words.shape[0], dtype=np.int64) * (words_per_group * 32)
        in_group = _numpy(block_offsets).reshape(-1).astype(np.int64) - np.repeat(
            base, group_size
        )
        if in_group.max(initial=0) >= 1 << 16:
            raise ValueError("in-group offset exceeds u16 sidecar range")
        return cls(
            words=group_words,
            group_word_counts=gwc,
            block_offsets=in_group.astype(np.uint16),
            block_counts=_numpy(block_counts).reshape(-1).astype(np.uint8),
            group_size=group_size,
            words_per_group=words_per_group,
        )

    def device_views(self, device="cpu"):
        """(words_flat int64, block_bit_offsets int32, block_counts int32)
        tensors on ``device``."""
        base = np.arange(self.group_word_counts.size, dtype=np.int64) * (
            self.words_per_group * 32
        )
        offs = np.repeat(base, self.group_size) + self.block_offsets.astype(np.int64)
        return (
            torch.from_numpy(self.words.reshape(-1).astype(np.int64)).to(device),
            torch.from_numpy(offs.astype(np.int32)).to(device),
            torch.from_numpy(self.block_counts.astype(np.int32)).to(device),
        )


@dataclass
class VideoPayload:
    """A coded GOP of the fused codec; decodable from the bytes alone.

      header     magic, version, kind=KIND_VIDEO_GOP, q, eob, search range,
                 T/H/W, payload bit count (exact residual+MV code lengths)
      codebooks  residual + motion-vector hot/escape codes
      sections   per-GOP residual grouped stream ([T*N] blocks, frames on
                 the block axis) + MV grouped stream (frames 1..T-1, 64
                 symbols per block)
    """

    quantization_scale: float
    eob: int
    search_range: int
    shape: tuple  # (T, H, W)
    payload_bits: int  # exact residual + MV code-length sum (the RD rate)
    frame_bits: np.ndarray  # [T] u64, per-frame residual payload bits
    residual_codebook: HotCodebook
    mv_codebook: HotCodebook
    residual: GroupedSection
    mv: GroupedSection

    def to_bytes(self) -> bytes:
        T, H, W = self.shape
        head = struct.pack(
            "<4sHBBfiIIIQ",
            MAGIC, VERSION, KIND_VIDEO_GOP, 0,
            self.quantization_scale, self.eob,
            T, H, W, self.payload_bits,
        ) + struct.pack("<B", self.search_range)
        return b"".join([
            head,
            np.asarray(self.frame_bits, dtype="<u8").tobytes(),
            self.residual_codebook.to_bytes(),
            self.mv_codebook.to_bytes(),
            self.residual.to_bytes(),
            self.mv.to_bytes(),
        ])

    @classmethod
    def from_bytes(cls, data: bytes):
        r = _Reader(memoryview(data))
        magic, version, kind, _, q, eob, T, H, W, pbits = r.unpack("<4sHBBfiIIIQ")
        if magic != MAGIC:
            raise ValueError("not an IVC1 container")
        if version != VERSION:
            raise ValueError(f"unsupported container version {version}")
        if kind != KIND_VIDEO_GOP:
            raise ValueError(f"not a video GOP container (kind={kind})")
        if not (0 < T <= MAX_DIM and 0 < H <= MAX_DIM and 0 < W <= MAX_DIM):
            raise ValueError(f"implausible GOP shape ({T}, {H}, {W})")
        (sr,) = r.unpack("<B")
        frame_bits = r.array("<u8", T, "frame bits")
        res_cb = HotCodebook.from_buffer(r)
        mv_cb = HotCodebook.from_buffer(r)
        residual = GroupedSection.from_buffer(r)
        mv = GroupedSection.from_buffer(r)
        return cls(q, eob, sr, (T, H, W), pbits, frame_bits, res_cb, mv_cb, residual, mv)

    @property
    def container_bytes(self) -> int:
        return len(self.to_bytes())

    def max_block_words(self) -> int:
        """Decoder shift-register bound from the sidecar (host, cheap)."""
        s = self.residual
        gs = s.group_size
        offs = s.block_offsets.astype(np.int64).reshape(-1, gs)
        ends = np.concatenate(
            [offs[:, 1:], (s.group_word_counts.astype(np.int64) * 32)[:, None]], axis=1
        )
        return int(((ends - offs).max() + 31) // 32) + 2
