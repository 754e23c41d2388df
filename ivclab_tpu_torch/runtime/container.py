"""IVC1 bitstream container: the wire formats of the intra codec, the fused
GOP codec and the per-frame adaptive video codec.

Port of ``ivclab_tpu/runtime/container.py``. The bytes are identical to the
JAX package's; a blob written by either side parses on the other.

Intra (``IntraPayload``, one coded image or plane):

  header      magic, version, kind (KIND_INTRA / KIND_PLANE), layout,
              quantization scale, EOB, H/W/C, symbol count, payload bits
  codebook    lower bound + canonical code lengths (u8 each): canonical
              codes are fully reconstructible from lengths
  layout      one contiguous bit stream, or the grouped layout below

Video GOP (``VideoPayload``):

  header      magic, version, kind=KIND_VIDEO_GOP, quantization scale, EOB,
              T/H/W, payload bit count, search range, per-frame bits
  codebooks   residual + motion-vector hot/escape codes (lower bound,
              alphabet size, hot alphabet indices, canonical lengths)
  sections    the grouped residual stream and the grouped MV stream

Adaptive video GOP (``AdaptiveVideoPayload``) and P-frame
(``PFramePayload``): per-frame residual codebooks (lower bound + canonical
lengths) beside each frame's grouped residual stream, and a uniform-pmf MV
codebook beside the grouped MV stream.

A grouped section is word-aligned per-group substreams plus the per-block
sidecar (u16 in-group bit offset + u8 symbol count) that lets every block
decode independently.

Parsing treats the bytes as hostile: every count is bounds-checked before
anything is allocated, and every failure is a ``ValueError``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from ivclab_tpu_torch.utils.shape import upload

MAGIC = b"IVC1"
VERSION = 1
KIND_INTRA = 0
KIND_PLANE = 1
KIND_VIDEO_GOP = 2
KIND_VIDEO_ADAPTIVE = 3
KIND_PFRAME = 4

LAYOUT_CONTIGUOUS = 0
LAYOUT_GROUPED = 1

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
class Codebook:
    """Transmissible form of a full-alphabet canonical code."""

    lower_bound: int
    lengths: np.ndarray  # [n] uint8

    def to_bytes(self) -> bytes:
        return struct.pack("<iI", self.lower_bound, self.lengths.size) + self.lengths.astype(
            np.uint8
        ).tobytes()

    @classmethod
    def from_buffer(cls, r: _Reader):
        lower, n = r.unpack("<iI")
        if n > MAX_CODEBOOK:
            raise ValueError(f"codebook size {n} exceeds the format bound")
        lengths = r.array(np.uint8, n, "codebook lengths")
        return cls(lower, lengths)

    def canonical(self):
        from ivclab_tpu_torch.entropy.codebook import canonical_from_lengths

        return canonical_from_lengths(self.lengths.astype(np.int32), self.lower_bound)


@dataclass
class IntraPayload:
    """One coded image or plane."""

    kind: int
    shape: tuple  # (H, W) or (H, W, C)
    quantization_scale: float
    eob: int
    num_symbols: int
    payload_bits: int
    codebook: Codebook
    layout: int
    # contiguous: the u32 words; grouped: [G, words_per_group] u32 words
    # (zero-padded tail) with the fields below
    words: np.ndarray
    group_word_counts: np.ndarray | None = None
    block_offsets: np.ndarray | None = None
    block_counts: np.ndarray | None = None
    group_size: int = 0
    words_per_group: int = 0

    def to_bytes(self) -> bytes:
        H = self.shape[0]
        W = self.shape[1]
        C = self.shape[2] if len(self.shape) == 3 else 0  # 0 encodes "2-D shape"
        head = struct.pack(
            "<4sHBBfiIIIQQ",
            MAGIC, VERSION, self.kind, self.layout, self.quantization_scale, self.eob,
            H, W, C, self.num_symbols, self.payload_bits,
        )
        body = [head, self.codebook.to_bytes()]
        if self.layout == LAYOUT_CONTIGUOUS:
            body.append(struct.pack("<Q", self.words.size))
            body.append(self.words.astype("<u4").tobytes())
        else:
            section = GroupedSection(self.words, self.group_word_counts, self.block_offsets,
                                     self.block_counts, self.group_size, self.words_per_group)
            body.append(section.to_bytes())
        return b"".join(body)

    @classmethod
    def from_bytes(cls, data: bytes):
        r = _Reader(memoryview(data))
        magic, version, kind, layout, q, eob, H, W, C, nsym, pbits = r.unpack("<4sHBBfiIIIQQ")
        if magic != MAGIC:
            raise ValueError("not an IVC1 container")
        if version != VERSION:
            raise ValueError(f"unsupported container version {version}")
        if kind not in (KIND_INTRA, KIND_PLANE):
            raise ValueError(f"not an intra/plane container (kind={kind})")
        if not (0 < H <= MAX_DIM and 0 < W <= MAX_DIM and C <= 4):
            raise ValueError(f"implausible image shape ({H}, {W}, {C})")
        codebook = Codebook.from_buffer(r)
        shape = (H, W) if C == 0 else (H, W, C)
        if layout == LAYOUT_CONTIGUOUS:
            (nwords,) = r.unpack("<Q")
            words = r.array("<u4", nwords, "stream words")
            return cls(kind, shape, q, eob, nsym, pbits, codebook, layout, words)
        section = GroupedSection.from_buffer(r)
        return cls(
            kind, shape, q, eob, nsym, pbits, codebook, layout, section.words,
            section.group_word_counts, section.block_offsets, section.block_counts,
            section.group_size, section.words_per_group,
        )

    @property
    def container_bytes(self) -> int:
        return len(self.to_bytes())


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
        ``block_offsets`` are bit offsets into the flattened stream: the
        unsliced case of :meth:`from_packer_sliced`.
        """
        return cls.from_packer_sliced(group_words, group_bits, block_offsets, block_counts,
                                      group_size, words_per_group, words_per_group)

    @classmethod
    def from_packer_sliced(cls, words, group_bits, block_offsets, block_counts,
                           group_size: int, packer_stride: int, wmax: int):
        """Assemble from width-sliced packer outputs (tensors or arrays).

        ``words`` is the ``[G, wmax]`` slice of a packer's ``[G,
        packer_stride]`` word buffer (the tail past every group's used
        words is empty); ``block_offsets`` are the packer's global bit
        offsets at ``packer_stride`` words per group, rebased here to the
        in-group u16 sidecar offsets. Raises ``ValueError`` when an offset
        does not fit the u16 sidecar.
        """
        gb = _numpy(group_bits).reshape(-1).astype(np.int64)
        G = gb.shape[0]
        base = np.arange(G, dtype=np.int64) * (packer_stride * 32)
        in_group = _numpy(block_offsets).reshape(-1).astype(np.int64) - np.repeat(
            base, group_size
        )
        if in_group.max(initial=0) >= 1 << 16:
            raise ValueError("in-group offset exceeds u16 sidecar range")
        return cls(
            words=_numpy(words).reshape(G, wmax).astype(np.uint32),
            group_word_counts=((gb + 31) // 32).astype(np.uint32),
            block_offsets=in_group.astype(np.uint16),
            block_counts=_numpy(block_counts).reshape(-1).astype(np.uint8),
            group_size=group_size,
            words_per_group=wmax,
        )

    def device_views(self, device="cuda"):
        """(words_flat int64, block_bit_offsets int32, block_counts int32)
        tensors on ``device``, uploaded without blocking the host. The
        offsets are cast to int32 as JAX's are: past 2^31 they wrap."""
        base = np.arange(self.group_word_counts.size, dtype=np.int64) * (
            self.words_per_group * 32
        )
        offs = np.repeat(base, self.group_size) + self.block_offsets.astype(np.int64)
        return (
            upload(self.words.reshape(-1).astype(np.int64), device),
            upload(offs.astype(np.int32), device),
            upload(self.block_counts.astype(np.int32), device),
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


@dataclass
class AdaptiveVideoPayload:
    """A coded GOP with per-frame residual codebooks: the wire format of the
    ``per-frame`` and ``adaptive`` codebook policies, decodable from the
    bytes alone.

      header     magic, version, kind=KIND_VIDEO_ADAPTIVE, policy flag,
                 q, eob, T/H/W, payload bit count, search range
      mv         Huffman codebook (uniform-pmf canonical lengths) + the
                 grouped MV stream of frames 1..T-1
      frames     T x [residual codebook + grouped residual stream]

    ``payload_bits`` and ``frame_bits`` follow the facade's rate accounting
    (exact residual + MV code lengths, plus the serialized-codebook charge
    on P-frames when ``policy == 1``, adaptive).
    """

    quantization_scale: float
    eob: int
    search_range: int
    policy: int  # 0 = per-frame (codebooks uncharged), 1 = adaptive
    shape: tuple  # (T, H, W)
    payload_bits: int
    frame_bits: np.ndarray  # [T] u64, per-frame bits (facade accounting)
    mv_codebook: Codebook
    mv: GroupedSection
    frames: list  # [T] of (Codebook, GroupedSection)

    def to_bytes(self) -> bytes:
        T, H, W = self.shape
        head = struct.pack(
            "<4sHBBfiIIIQ",
            MAGIC, VERSION, KIND_VIDEO_ADAPTIVE, self.policy,
            self.quantization_scale, self.eob,
            T, H, W, self.payload_bits,
        ) + struct.pack("<B", self.search_range)
        parts = [
            head,
            np.asarray(self.frame_bits, dtype="<u8").tobytes(),
            self.mv_codebook.to_bytes(),
            self.mv.to_bytes(),
        ]
        for cb, section in self.frames:
            parts.append(cb.to_bytes())
            parts.append(section.to_bytes())
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes):
        r = _Reader(memoryview(data))
        magic, version, kind, policy, q, eob, T, H, W, pbits = r.unpack("<4sHBBfiIIIQ")
        if magic != MAGIC:
            raise ValueError("not an IVC1 container")
        if version != VERSION:
            raise ValueError(f"unsupported container version {version}")
        if kind != KIND_VIDEO_ADAPTIVE:
            raise ValueError(f"not an adaptive video container (kind={kind})")
        if not (0 < T <= MAX_DIM and 0 < H <= MAX_DIM and 0 < W <= MAX_DIM):
            raise ValueError(f"implausible GOP shape ({T}, {H}, {W})")
        (sr,) = r.unpack("<B")
        frame_bits = r.array("<u8", T, "frame bits")
        mv_cb = Codebook.from_buffer(r)
        mv = GroupedSection.from_buffer(r)
        frames = [(Codebook.from_buffer(r), GroupedSection.from_buffer(r)) for _ in range(T)]
        return cls(q, eob, sr, policy, (T, H, W), pbits, frame_bits, mv_cb, mv, frames)

    @property
    def container_bytes(self) -> int:
        return len(self.to_bytes())


@dataclass
class PFramePayload:
    """One coded P-frame of the facade ``VideoCodec.encode_decode``: both
    codebooks (canonical lengths), the grouped MV stream and the grouped
    residual stream; a decoder that holds the previous reconstruction needs
    nothing else."""

    quantization_scale: float
    eob: int
    search_range: int
    shape: tuple  # (H, W)
    payload_bits: int  # exact MV + residual code-length sum (the RD rate)
    mv_codebook: Codebook
    mv: GroupedSection
    residual_codebook: Codebook
    residual: GroupedSection

    def to_bytes(self) -> bytes:
        H, W = self.shape
        head = struct.pack(
            "<4sHBBfiIIQ",
            MAGIC, VERSION, KIND_PFRAME, 0,
            self.quantization_scale, self.eob, H, W, self.payload_bits,
        ) + struct.pack("<B", self.search_range)
        return b"".join([
            head,
            self.mv_codebook.to_bytes(),
            self.mv.to_bytes(),
            self.residual_codebook.to_bytes(),
            self.residual.to_bytes(),
        ])

    @classmethod
    def from_bytes(cls, data: bytes):
        r = _Reader(memoryview(data))
        magic, version, kind, _, q, eob, H, W, pbits = r.unpack("<4sHBBfiIIQ")
        if magic != MAGIC:
            raise ValueError("not an IVC1 container")
        if version != VERSION:
            raise ValueError(f"unsupported container version {version}")
        if kind != KIND_PFRAME:
            raise ValueError(f"not a P-frame container (kind={kind})")
        if not (0 < H <= MAX_DIM and 0 < W <= MAX_DIM):
            raise ValueError(f"implausible frame shape ({H}, {W})")
        (sr,) = r.unpack("<B")
        mv_cb = Codebook.from_buffer(r)
        mv = GroupedSection.from_buffer(r)
        res_cb = Codebook.from_buffer(r)
        residual = GroupedSection.from_buffer(r)
        return cls(q, eob, sr, (H, W), pbits, mv_cb, mv, res_cb, residual)

    @property
    def container_bytes(self) -> int:
        return len(self.to_bytes())


def packer_wmax(gb_np, packer_stride: int) -> int:
    """Used-words bound of a packed group batch, 8-aligned: the width a
    section is sliced to before it is fetched and serialized."""
    wmax = max(int((int(np.asarray(gb_np).max(initial=0)) + 31) // 32), 1)
    return min(-(-wmax // 8) * 8, packer_stride)


def grouped_payload_from_device(
    kind, shape, q, eob, num_symbols, group_words, group_bits, block_offsets, block_counts,
    codebook: Codebook, words_per_group: int, group_size: int,
) -> IntraPayload:
    """Assemble an IntraPayload from the grouped packer's outputs (tensors
    or arrays; ``block_offsets`` are bit offsets into the flattened groups
    at ``words_per_group`` stride). Raises ``ValueError`` when an in-group
    offset overflows the u16 sidecar."""
    s = GroupedSection.from_device(group_words, group_bits, block_offsets, block_counts,
                                   group_size, words_per_group)
    return IntraPayload(
        kind=kind,
        shape=tuple(int(d) for d in shape),
        quantization_scale=float(q),
        eob=int(eob),
        num_symbols=int(num_symbols),
        payload_bits=int(_numpy(group_bits).astype(np.int64).sum()),
        codebook=codebook,
        layout=LAYOUT_GROUPED,
        words=s.words,
        group_word_counts=s.group_word_counts,
        block_offsets=s.block_offsets,
        block_counts=s.block_counts,
        group_size=group_size,
        words_per_group=words_per_group,
    )


def device_views(payload: IntraPayload, device="cuda"):
    """(words_flat int64, block_bit_offsets int32, block_counts int32)
    tensors on ``device`` for the block-parallel decoder."""
    if payload.layout != LAYOUT_GROUPED:
        raise ValueError("device decode needs the grouped layout")
    section = GroupedSection(payload.words, payload.group_word_counts, payload.block_offsets,
                             payload.block_counts, payload.group_size, payload.words_per_group)
    return section.device_views(device)
