"""Fixed-codebook GOP codec: the throughput path.

Port of ``ivclab_tpu/models/fastvideo.py``. Each phase works on a whole
GOP at once, on the codec's device:

  encode:  per frame, full-search ME (the Hopper kernel on CUDA), gather
           MC, fused DCT+quant as one ``[N,64]x[64,64]`` matmul, and the
           IDCT that rebuilds the reference for the next frame;
  pack:    zero-run + hot/escape Huffman packing of all T*N blocks in one
           flat pass (frames folded into the block axis) into word-aligned
           16-block group substreams whose buffer sizes are bucketed from
           the GOP's measured extents;
  decode:  per-block local streams, the block-parallel canonical walk,
           zero-run decode, fused IDCT, and the MC rebuild of the recon
           chain.

Codebooks are fixed per sequence (trained on the first frames), so the GOP
recursion never waits on the host for a table. The codec has no random
state. Every integer it produces (motion indices, symbols, code words, bit
offsets, container bytes) equals the JAX package's on the same input.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ivclab_tpu_torch.entropy.codebook import HotCode, build_hot_code, hot_code_from_parts
from ivclab_tpu_torch.models.intracodec import _sym_min_max, bucket_bounds
from ivclab_tpu_torch.ops.bitpack import decode_blocks_hot, locals_from_groups
from ivclab_tpu_torch.ops.dct import dct2_fused, require_full_fp32
from ivclab_tpu_torch.ops.motion import motion_compensate, motion_search
from ivclab_tpu_torch.ops.quant import quant_table_zigzag
from ivclab_tpu_torch.ops.transform import (
    PACK_GROUP,
    blocks_from_plane,
    forward_symbolize,
    inverse_reconstruct,
    map_codes_hot,
    map_gop_hot,
    pack_extents,
    pack_grouped_sized,
    symbol_histogram,
)
from ivclab_tpu_torch.ops.zerorun import zerorun_counts, zerorun_decode_blocks
from ivclab_tpu_torch.runtime.container import GroupedSection, HotCodebook, VideoPayload
from ivclab_tpu_torch.runtime.trace import fetch, span
from ivclab_tpu_torch.utils.shape import upload

EOB = 4000

# Size buckets: the extent pre-passes pick the smallest adequate bucket per
# GOP. The GW bucket is written into the container as words_per_group.
CAP_BUCKETS = (32, 64, 128)        # symbols per block (97 = worst case)
GW_BUCKETS = (64, 128, 256, 512, 1024, 2048)  # words per 16-block group
BW_BUCKETS = (4, 8, 16, 32, 64, 128)          # words per block stream


def _bucket(v: int, buckets) -> int:
    for b in buckets:
        if b >= v:
            return b
    raise ValueError(f"{v} exceeds the largest bucket {buckets[-1]}")


class PackedGop(NamedTuple):
    """Result of :meth:`FusedVideoCodec.pack_gop` (tensors on the device)."""

    words: torch.Tensor       # [T, G, GW] int64 32-bit group substream words
    totals: torch.Tensor      # [T] exact residual payload bits
    offsets: torch.Tensor     # [T, N] frame-relative block bit offsets
    counts: torch.Tensor      # [T, N] per-block symbol counts
    group_bits: torch.Tensor  # [T, G] exact per-group bits
    block_words: int          # decoder shift-register width (bucketed)
    cap: int                  # symbol-capacity bucket
    ok: torch.Tensor          # device bool: sticky buckets were adequate


# --------------------------------------------------------------------- phases


def _symbolize(plane, qt, inv_qt):
    """[H, W] plane -> (scan-ordered quantized symbols [N, 64] int32, the
    decoder's reconstruction of the plane)."""
    coeffs = dct2_fused(blocks_from_plane(plane[:, :, None]))
    qsym = torch.round(coeffs * inv_qt[None, :]).to(torch.int32)
    return qsym, inverse_reconstruct(qsym, qt[None], (*plane.shape, 1))[:, :, 0]


def _encode_gop(frames_y, qt, inv_qt, mv_lens, sr: int):
    """[T, H, W] float32 -> per-frame (qsyms, mvs, mv_bits, recons)."""
    T, H, W = frames_y.shape
    dev = frames_y.device

    qsyms, mvs, mv_bits, recons = [], [], [], []
    for t in range(T):
        y = frames_y[t]
        if t == 0:
            qsym, recon = _symbolize(y, qt, inv_qt)
            mv = torch.full((H // 8, W // 8), sr * (2 * sr + 1) + sr, dtype=torch.int32, device=dev)
            bits = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            mv = motion_search(recon, y, sr)
            pred = motion_compensate(recon, mv, sr)
            qsym, rrec = _symbolize(y - pred, qt, inv_qt)
            bits = mv_lens[mv.clamp(0, mv_lens.shape[0] - 1).long()].sum(dtype=torch.int32)
            recon = pred + rrec
        qsyms.append(qsym)
        mvs.append(mv)
        mv_bits.append(bits)
        recons.append(recon)
    return torch.stack(qsyms), torch.stack(mvs), torch.stack(mv_bits), torch.stack(recons)


def _map_gop_hot(qsyms, hot_vals, hot_fused, esc_code, esc_len, lower_bound, cap: int,
                 raw_bits: int):
    """Zero-run encode + hot/escape code mapping, flat over T*N
    (:func:`map_gop_hot`: the map kernel on a card).

    Also returns the pack extents (max block words, max group words) and a
    capacity flag, so the caller can check its sticky buckets on the device.
    """
    T, N, _ = qsyms.shape
    with span("ivc.pack.map", qsyms.device):
        return map_gop_hot(qsyms.reshape(T * N, 64), hot_vals, hot_fused, esc_code, esc_len,
                           lower_bound, cap, raw_bits, EOB)


def _decode_gop_hot(words, block_offsets, block_counts, mvs, lj, first_code, group_offset,
                    alpha_of_rank, min_len, esc_rank, lower_bound, qt, H: int, W: int,
                    cap: int, lw: int, sr: int, raw_bits: int, max_len: int = 16):
    """Entropy decode + reconstruct a GOP. Returns (recons [T, H, W], ok)."""
    T, G, GW = words.shape
    dev = words.device
    frame_base = (torch.arange(T, device=dev, dtype=torch.int64) * (G * GW * 32))[:, None]
    offs = (block_offsets.to(torch.int64) + frame_base).reshape(-1)
    cnts = block_counts.reshape(-1).to(torch.int32)

    local = locals_from_groups(words.reshape(T * G, GW), offs, PACK_GROUP, lw)
    sym_idx = decode_blocks_hot(local, cnts, lj, first_code, group_offset, alpha_of_rank,
                                min_len, esc_rank, cap, raw_bits, max_len)
    in_count = torch.arange(cap, device=dev)[None, :] < cnts[:, None]
    syms = torch.where(in_count, sym_idx + lower_bound, 0)
    blocks, ok = zerorun_decode_blocks(syms, cnts, 64, EOB)
    # the frames' blocks in order are the blocks of their planes stacked on the rows
    planes = inverse_reconstruct(blocks, qt[None], (T * H, W, 1)).reshape(T, H, W)

    recons = []
    recon = torch.zeros((H, W), dtype=torch.float32, device=dev)
    for t in range(T):
        pred = torch.zeros_like(recon) if t == 0 else motion_compensate(recon, mvs[t], sr)
        recon = pred + planes[t]
        recons.append(recon)
    return torch.stack(recons), ok


def _map_stream_hot(flat_syms, hot_vals, hot_fused, esc_code, esc_len, n_blocks: int,
                    raw_bits: int):
    """Flat symbol stream -> 64-symbol blocks + hot code mapping."""
    M = flat_syms.shape[0]
    S = 64
    dev = flat_syms.device
    padded = torch.zeros(n_blocks * S, dtype=torch.int32, device=dev)
    padded[:M] = flat_syms
    buf = padded.reshape(n_blocks, S)
    counts = (M - torch.arange(n_blocks, dtype=torch.int32, device=dev) * S).clamp(0, S)
    codes, lens = map_codes_hot(buf, counts, hot_vals, hot_fused, esc_code, esc_len, raw_bits)
    bw_max, gw_max = pack_extents(lens)
    return codes, lens, counts, bw_max, gw_max


class _DecodeTables(NamedTuple):
    lj: torch.Tensor
    first_code: torch.Tensor
    group_offset: torch.Tensor
    alpha_of_rank: torch.Tensor
    min_len: int
    esc_rank: int


def _decode_tables(code: HotCode, device) -> _DecodeTables:
    c = code.code
    lj, fc, go, ar = (upload(np.asarray(a).astype(np.int64), device) for a in (
        c.lj_next_minus1, c.first_code, c.group_offset, code.alpha_of_rank))
    return _DecodeTables(lj, fc, go, ar, int(c.min_len), int(code.esc_rank))


def _encode_tables(code: HotCode, device):
    """(hot_values, hot_fused, esc_code, esc_len) for :func:`map_codes_hot`."""
    hv = np.asarray(code.hot_values, dtype=np.int64)
    if hv.size and (hv.min() < 0 or hv.max() >= 1 << code.raw_bits):
        raise ValueError("hot values must lie in [0, 2^raw_bits)")
    fused = code.fused_table()[: code.K].astype(np.int64)
    return (upload(hv, device), upload(fused, device),
            int(code.code.codes[code.K]), int(code.code.lengths[code.K]))


def _decode_stream_hot(words, offsets, counts, tables: _DecodeTables, cap: int, lw: int,
                       raw_bits: int, max_len: int = 16):
    local = locals_from_groups(words, offsets, PACK_GROUP, lw)
    return decode_blocks_hot(local, counts, tables.lj, tables.first_code, tables.group_offset,
                             tables.alpha_of_rank, tables.min_len, tables.esc_rank, cap,
                             raw_bits, max_len)


class FusedVideoCodec:
    """Fixed-codebook hybrid codec; every GOP phase runs on ``device``."""

    def __init__(self, quantization_scale: float = 1.0, search_range: int = 4,
                 device: str | torch.device = "cuda"):
        self.q = float(quantization_scale)
        self.sr = int(search_range)
        self.device = torch.device(device)
        qt = quant_table_zigzag(self.q, 1)[0]
        self.qt = upload(qt, self.device)
        self.inv_qt = upload((1.0 / qt).astype(np.float32), self.device)
        self.residual_code: HotCode | None = None
        self.mv_code: HotCode | None = None
        self._buckets: tuple[int, int, int] | None = None
        self._mv_lens: tuple[HotCode, torch.Tensor] | None = None

    @classmethod
    def from_reference_state(cls, state: dict, device: str | torch.device = "cuda"):
        """A codec computing what a trained JAX ``FusedVideoCodec`` computes.

        ``state`` holds plain numbers and numpy arrays:
        ``quantization_scale``, ``search_range``, ``residual_code`` and
        ``mv_code`` as ``(lower_bound, alphabet_n, hot_values, lengths)``
        (lengths of the K hot symbols plus ESCAPE), and ``buckets``, the
        sticky ``(cap, block_words, group_words)`` or None.
        """
        codec = cls(state["quantization_scale"], state["search_range"], device)
        codec.set_residual_code(hot_code_from_parts(*state["residual_code"]))
        codec.mv_code = hot_code_from_parts(*state["mv_code"])
        buckets = state.get("buckets")
        codec._buckets = None if buckets is None else tuple(int(b) for b in buckets)
        return codec

    def _frames(self, frames_y) -> torch.Tensor:
        if isinstance(frames_y, torch.Tensor):
            t = frames_y.to(device=self.device, dtype=torch.float32)
        else:
            t = upload(np.asarray(frames_y, dtype=np.float32), self.device)
        return t.contiguous()

    def _require_fp32(self):
        if self.device.type == "cuda":
            require_full_fp32()

    # ------------------------------------------------------------ training

    def train(self, frames_y):
        """Fit residual + MV codebooks from a few frames (once per sequence)."""
        frames = self._frames(frames_y)
        self._require_fp32()
        # I-frame stats from frame 0; P-residual stats from frame 1 if present
        planes = [frames[0]]
        if frames.shape[0] > 1:
            mv = motion_search(frames[0], frames[1], self.sr)
            planes.append(frames[1] - motion_compensate(frames[0], mv, self.sr))
        bufs = []
        for p in planes:
            buf, valid, _ = forward_symbolize(p[:, :, None], self.inv_qt[None], EOB)
            bufs.append((buf, valid))
        mn = min(int(fetch(_sym_min_max(b, v)[0])) for b, v in bufs)
        mx = max(int(fetch(_sym_min_max(b, v)[1])) for b, v in bufs)
        lo, hi = bucket_bounds(mn, mx)
        hist = sum(fetch(symbol_histogram(b, v, lo, hi)).numpy() for b, v in bufs)
        self.set_residual_code(build_hot_code(hist, lower_bound=lo))

        n_mv = (2 * self.sr + 1) ** 2
        self.mv_code = build_hot_code(np.ones(n_mv), lower_bound=0, K=n_mv)
        return self

    def set_residual_code(self, code: HotCode):
        """Install a residual hot/escape codebook and its device tables."""
        self.residual_code = code
        self._enc = _encode_tables(code, self.device)
        self._dec = _decode_tables(code, self.device)
        self._buckets = None  # sticky pack buckets are per-codebook
        return self

    # ------------------------------------------------------------ phases

    def encode_gop(self, frames_y):
        """[T, H, W] float32 -> (qsyms [T, N, 64], mvs [T, H/8, W/8],
        mv_bits [T], recons [T, H, W])."""
        with span("ivc.fused.encode_gop", self.device):
            frames = self._frames(frames_y)
            self._require_fp32()
            return _encode_gop(frames, self.qt, self.inv_qt, self._mv_length_table(), self.sr)

    def _mv_length_table(self) -> torch.Tensor:
        """Each motion index's code length, on the device: built once for
        each ``mv_code`` object (``train``, ``from_reference_state`` and the
        container decode each install a new one), so a warm ``encode_gop``
        copies nothing from the host."""
        mvc = self.mv_code
        if self._mv_lens is None or self._mv_lens[0] is not mvc:
            # the MV code's hot values are sorted by frequency, so map each
            # alphabet index to its code length (escape length where not hot)
            lens = np.zeros(mvc.alphabet_n, dtype=np.int32)
            lens[mvc.hot_values] = mvc.code.lengths[: mvc.K]
            lens[lens == 0] = int(mvc.code.lengths[mvc.K]) + mvc.raw_bits
            self._mv_lens = (mvc, upload(lens, self.device))
        return self._mv_lens[1]

    def pack_gop(self, qsyms, check: bool = True) -> PackedGop:
        """Hot/escape Huffman packing of the residual symbol buffers.

        Size buckets are sticky: the first GOP after (re)training reads its
        extents on the host to pick the symbol-capacity, group-words and
        block-words buckets; later GOPs pack with those buckets and compute
        the adequacy flag on the device. With ``check=True`` the flag is
        read and a violation (content grew) re-buckets and re-packs; with
        ``check=False`` no host read happens once the buckets exist, and
        the caller checks ``.ok`` at its next sync point (re-packing with
        :meth:`repack_gop` if it is False).
        """
        with span("ivc.fused.pack_gop", qsyms.device):
            return self._pack_gop(qsyms, check)

    def _pack_gop(self, qsyms, check: bool) -> PackedGop:
        code = self.residual_code
        hv, hf, esc_code, esc_len = self._enc
        dev = qsyms.device
        if self._buckets is None:
            cap = _bucket(int(fetch(zerorun_counts(qsyms.reshape(-1, 64)).max())), CAP_BUCKETS)
            codes, lens, valid, bw_max, gw_max, _ = _map_gop_hot(
                qsyms, hv, hf, esc_code, esc_len, code.lower_bound, cap, code.raw_bits)
            bw = _bucket(int(fetch(bw_max)) + 2, BW_BUCKETS)
            gw = _bucket(int(fetch(gw_max)), GW_BUCKETS)
            self._buckets = (cap, bw, gw)
            okflag = torch.ones((), dtype=torch.bool, device=dev)
        else:
            cap, bw, gw = self._buckets
            codes, lens, valid, bw_max, gw_max, cap_ok = _map_gop_hot(
                qsyms, hv, hf, esc_code, esc_len, code.lower_bound, cap, code.raw_bits)
            okflag = cap_ok & (bw_max + 2 <= bw) & (gw_max <= gw)
        group_words, group_bits, offsets = pack_grouped_sized(codes, lens, gw, bw)

        T, N, _ = qsyms.shape
        G = group_words.shape[0] // T
        words = group_words.reshape(T, G, gw)
        frame_base = (torch.arange(T, device=dev, dtype=torch.int32) * (G * gw * 32))[:, None]
        offs = offsets.reshape(T, N) - frame_base
        gbits = group_bits.reshape(T, G)
        p = PackedGop(words, gbits.sum(dim=1, dtype=torch.int32), offs, valid.reshape(T, N),
                      gbits, bw, cap, okflag)
        if check and not bool(fetch(okflag)):
            return self.repack_gop(qsyms)
        return p

    def repack_gop(self, qsyms) -> PackedGop:
        """Drop the sticky buckets and re-pack (bucket-violation recovery)."""
        self._buckets = None
        return self.pack_gop(qsyms)

    def decode_gop(self, words, block_offsets, block_counts, mvs, H: int, W: int,
                   block_words: int | None = None, cap: int | None = None):
        """Entropy decode + reconstruct the GOP. Returns (recons, ok)."""
        with span("ivc.fused.decode_gop", words.device):
            code = self.residual_code
            if cap is None:
                cap = _bucket(int(fetch(block_counts.max())), CAP_BUCKETS)
            if block_words is None:
                # conservative: every symbol at the max coded length
                block_words = _bucket(cap * code.mean_len_bound() // 32 + 2, BW_BUCKETS)
            self._require_fp32()
            d = self._dec
            return _decode_gop_hot(
                words, block_offsets, block_counts, mvs,
                d.lj, d.first_code, d.group_offset, d.alpha_of_rank, d.min_len, d.esc_rank,
                code.lower_bound, self.qt, H, W, cap, block_words, self.sr, code.raw_bits,
                code.code.max_len,
            )

    # ------------------------------------------------------------ container

    def encode_to_container(self, frames_y) -> bytes:
        """Encode a GOP into a self-contained IVC1 video payload: header,
        hot/escape codebooks (residual + MV), the grouped residual streams
        with their parallel-decode sidecar, and the packed MV streams for
        frames 1..T-1."""
        with span("ivc.fused.encode_to_container"):
            frames = self._frames(frames_y)
            qsyms, mvs, _, _ = self.encode_gop(frames)
            p = self.pack_gop(qsyms)
            return self.container_from_packed(p, mvs, tuple(frames.shape))

    def container_from_packed(self, p: PackedGop, mvs, shape) -> bytes:
        """Serialize an already-packed GOP (+ motion fields) to IVC1 bytes."""
        T, H, W = shape
        mv_flat = mvs[1:].reshape(-1).to(torch.int32)
        M = int(mv_flat.shape[0])
        n_blocks = max(-(-M // 64), 1)
        n_blocks = -(-n_blocks // PACK_GROUP) * PACK_GROUP
        mvc = self.mv_code
        hv, hf, esc_code, esc_len = _encode_tables(mvc, mv_flat.device)
        codes, lens, mv_counts, bw_max, gw_max = _map_stream_hot(
            mv_flat, hv, hf, esc_code, esc_len, n_blocks, mvc.raw_bits)
        mv_bw = _bucket(int(fetch(bw_max)) + 2, BW_BUCKETS)
        mv_gw = _bucket(int(fetch(gw_max)), GW_BUCKETS)
        mv_words, mv_gbits, mv_offs = pack_grouped_sized(codes, lens, mv_gw, mv_bw)

        _, G, GW = p.words.shape
        frame_base = np.arange(T, dtype=np.int64)[:, None] * (G * GW * 32)
        global_offs = fetch(p.offsets).numpy().astype(np.int64) + frame_base
        residual = GroupedSection.from_device(
            p.words, p.group_bits, global_offs, p.counts, PACK_GROUP, GW)
        mv_section = GroupedSection.from_device(
            mv_words, mv_gbits, mv_offs, mv_counts, PACK_GROUP, mv_gw)
        totals = fetch(p.totals).numpy().astype(np.uint64)
        payload = VideoPayload(
            quantization_scale=self.q,
            eob=EOB,
            search_range=self.sr,
            shape=(T, H, W),
            payload_bits=int(totals.sum()) + int(fetch(mv_gbits.sum())),
            frame_bits=totals,
            residual_codebook=HotCodebook.from_code(self.residual_code),
            mv_codebook=HotCodebook.from_code(mvc),
            residual=residual,
            mv=mv_section,
        )
        return payload.to_bytes()

    @classmethod
    def decode_from_container(cls, blob: bytes, device: str | torch.device = "cuda"):
        """Reconstruct a GOP from bytes alone. Returns ([T, H, W] float32
        Y reconstructions, ok) on ``device``."""
        with span("ivc.fused.decode_from_container"):
            with span("ivc.decode.parse"):
                p = VideoPayload.from_bytes(blob)
            T, H, W = p.shape
            with span("ivc.decode.tables"):
                codec = cls(quantization_scale=p.quantization_scale,
                            search_range=p.search_range, device=device)
                codec.set_residual_code(p.residual_codebook.to_code())
                mvc = p.mv_codebook.to_code()
                codec.mv_code = mvc
                mv_tables = _decode_tables(mvc, codec.device)
            with span("ivc.decode.upload"):
                mv_words, mv_offs, mv_counts = p.mv.device_views(codec.device)
                words_flat, offs, counts = p.residual.device_views(codec.device)
            with span("ivc.decode.enqueue"):
                # MV substream first
                mv_lw = min(p.mv.words_per_group,
                            _bucket(64 * mvc.mean_len_bound() // 32 + 2, BW_BUCKETS))
                sym = _decode_stream_hot(
                    mv_words.reshape(-1, p.mv.words_per_group), mv_offs, mv_counts,
                    mv_tables, 64, mv_lw, mvc.raw_bits, mvc.code.max_len)
                hb, wb = H // 8, W // 8
                M = (T - 1) * hb * wb
                if sym.numel() < M:
                    raise ValueError("MV section holds fewer symbols than the GOP needs")
                mv_p = sym.reshape(-1)[:M].reshape(T - 1, hb, wb)
                filler = torch.full((1, hb, wb), codec.sr * (2 * codec.sr + 1) + codec.sr,
                                    dtype=torch.int32, device=codec.device)
                mvs = torch.cat([filler, mv_p], dim=0)

                # residual streams
                G = p.residual.group_word_counts.size // T
                GW = p.residual.words_per_group
                words = words_flat.reshape(T, G, GW)
                frame_base = (torch.arange(T, device=codec.device, dtype=torch.int32)
                              * (G * GW * 32))
                offsets = offs.reshape(T, -1) - frame_base[:, None]
                counts = counts.reshape(T, -1)
                cap = _bucket(int(p.residual.block_counts.max(initial=1)), CAP_BUCKETS)
                bw = _bucket(p.max_block_words(), BW_BUCKETS)
                return codec.decode_gop(words, offsets, counts, mvs, H, W, bw, cap)

    # ------------------------------------------------------------ one-call

    def encode_decode_gop(self, frames_y):
        """Full encode -> pack -> decode round trip.

        Returns (recons, bits_per_frame, ok, encoder_recons).
        """
        frames = self._frames(frames_y)
        qsyms, mvs, mv_bits, enc_recons = self.encode_gop(frames)
        p = self.pack_gop(qsyms)
        bits = p.totals + mv_bits
        T, H, W = frames.shape
        recons, ok = self.decode_gop(p.words, p.offsets, p.counts, mvs, H, W,
                                     p.block_words, p.cap)
        return recons, bits, ok, enc_recons
