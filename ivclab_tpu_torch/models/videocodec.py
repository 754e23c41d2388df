"""Hybrid I/P video codec with per-frame codebooks.

Port of ``ivclab_tpu/models/videocodec.py``: motion-compensated prediction
with intra-coded residuals, one codec with three ``codebook_policy`` values:

- ``"per-frame"``: retrain the residual codebook every frame (codebook
  transmission not counted, as in the course reference);
- ``"adaptive"``: retrain every frame and charge the serialized codebook's
  bits to the stream;
- ``"first-p-frame"``: train once on the first P-frame and reuse it
  (out-of-alphabet symbols clamp to the alphabet's edge).

Frame recursion runs against the decoder's reconstruction, so encoder and
decoder stay in lockstep. Motion symbols are 0-based over the
``(2 sr + 1)^2`` alphabet with a uniform-pmf code.

Entry points:

- ``encode_decode`` / ``decode_frame_payload``: the course reference's
  frame-by-frame facade; every frame also comes out as a self-contained
  IVC1 blob;
- ``encode_to_container`` / ``decode_from_container``: a luma GOP in one
  ``AdaptiveVideoPayload``. The device work of every frame (motion search,
  which is the Hopper kernel on the card, compensation, transform,
  reconstruction, histogram) runs as one loop without a host
  synchronisation; then one fetch of the per-frame statistics, the host
  codebook builds, the packs, one fetch of their sidecars and one of the
  words;
- ``encode_decode_sequence{,_pipelined,_checkpointed}``.

Frames come in as numpy arrays or tensors; reconstructions are tensors on
the codec's ``device`` (``decode_from_container`` returns host numpy unless
``return_device``); bit streams are host numpy; containers are ``bytes``.
Every integer and container byte equals the JAX package's on the same
input.
"""

from __future__ import annotations

import numpy as np
import torch

from ivclab_tpu_torch.entropy.codebook import canonical_from_lengths
from ivclab_tpu_torch.entropy.huffman import HuffmanCoder
from ivclab_tpu_torch.entropy.stats import pmf_from_histogram
from ivclab_tpu_torch.models.intracodec import (
    IntraCodec,
    IntraCodecAdaptive,
    _pad_blocks,
    _sym_min_max,
    bucket_bounds,
)
from ivclab_tpu_torch.models.intracodec import reference_state as intra_reference_state
from ivclab_tpu_torch.ops import transform as tf
from ivclab_tpu_torch.ops.bitpack import decode_blocks_device, decode_tables
from ivclab_tpu_torch.ops.color import rgb2ycbcr, ycbcr2rgb
from ivclab_tpu_torch.ops.dct import require_full_fp32
from ivclab_tpu_torch.ops.motion import motion_compensate, motion_search
from ivclab_tpu_torch.ops.quant import quant_table_zigzag
from ivclab_tpu_torch.ops.transform import (
    GROUP_WORDS,
    PACK_GROUP,
    cap_slice,
    forward_symbolize,
    inverse_reconstruct,
    pack_symbols_grouped,
    symbol_histogram,
)
from ivclab_tpu_torch.ops.zerorun import BLOCK_CAP, zerorun_decode_blocks
from ivclab_tpu_torch.runtime import native
from ivclab_tpu_torch.runtime.container import (
    KIND_PFRAME,
    KIND_VIDEO_ADAPTIVE,
    MAGIC,
    AdaptiveVideoPayload,
    Codebook,
    GroupedSection,
    PFramePayload,
    _numpy,
    packer_wmax,
)
from ivclab_tpu_torch.runtime.trace import fetch, span, upload_pageable
from ivclab_tpu_torch.utils.shape import upload

CODEBOOK_POLICIES = ("per-frame", "adaptive", "first-p-frame")

# Full-range histogram window of the container paths: it holds every
# bucketed bound a per-frame codebook can pick (EOB=4000 included), so each
# frame's training histogram is a slice of it, computed in the device loop.
_HIST_LO, _HIST_HI = -4096, 4160

# The JAX package counts this narrower window with a compare-reduce (TPU
# scatter-adds are slow) and takes a full histogram when a non-EOB symbol
# falls outside it; both give the same integers, which the one count here
# gives too.
_WIN_LO, _WIN_HI = -512, 576
_TRASH = 1024  # spare bins for padded slots: no single address takes them all


def _stream_histogram(buf: torch.Tensor, valid: torch.Tensor):
    """(min, max, ``[_HIST_LO, _HIST_HI)`` histogram) of the valid symbols,
    device tensors computed without a host synchronisation (a masked
    ``bincount`` would read its input's size back)."""
    n = _HIST_HI - _HIST_LO
    pos = torch.arange(buf.shape[1], device=buf.device)
    v = buf.to(torch.int64)
    keep = (pos[None, :] < valid[:, None]) & (v >= _HIST_LO) & (v < _HIST_HI)
    spare = n + torch.arange(v.numel(), device=buf.device).reshape(v.shape) % _TRASH
    idx = torch.where(keep, v - _HIST_LO, spare).reshape(-1)
    hist = torch.zeros(n + _TRASH, dtype=torch.int32, device=buf.device)
    hist.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    mn, mx = _sym_min_max(buf, valid)
    return mn, mx, hist[:n]


def _pframe_core(y, recon_prev, intra: bool, inv_qt, qt, sr: int, eob: int):
    """One frame's device work: motion search and compensation against the
    previous reconstruction (none for an I-frame), the residual's
    transform, quantisation and zero-run symbols, the closed-loop
    reconstruction (the entropy stage is lossless, so it never waits on
    the codebook), and the statistics the host needs to build the frame's
    codebook. Returns (buf, valid, min, max, histogram, motion field,
    reconstruction, largest symbol count)."""
    H, W = y.shape
    if intra:
        pred = None
        mv = torch.zeros((H // 8, W // 8), dtype=torch.int32, device=y.device)
        residual = y
    else:
        mv = motion_search(recon_prev, y, sr)
        pred = motion_compensate(recon_prev, mv, sr)
        residual = y - pred
    buf, valid, qsym = forward_symbolize(residual[:, :, None], inv_qt, eob)
    rrec = inverse_reconstruct(qsym, qt, (H, W, 1))[:, :, 0]
    recon = rrec if pred is None else pred + rrec
    mn, mx, hist = _stream_histogram(buf, valid)
    return buf, valid, mn, mx, hist, mv, recon, valid.max()


def _pframe_scan(frames_y, local_ts, inv_qt, qt, sr: int, eob: int):
    """:func:`_pframe_core` over ``[T, H, W]`` frames, the reconstruction
    carried on the device from frame to frame; ``local_ts`` are the in-GOP
    indices (0 opens a GOP with an I-frame). Returns the stacked outputs."""
    outs, recon = [], None
    for t, y in zip(local_ts, frames_y):
        out = _pframe_core(y, recon, int(t) == 0, inv_qt, qt, sr, eob)
        recon = out[6]
        outs.append(out)
    return [torch.stack(x) for x in zip(*outs)]


def _masked_code_bits(buf, valid, enc_lens, lower):
    """Exact coded bits of the valid symbols under a trained code (0-d tensor)."""
    pos = torch.arange(buf.shape[1], device=buf.device)
    mask = pos[None, :] < valid[:, None]
    idx = (buf.to(torch.int64) - lower).clamp(0, enc_lens.shape[0] - 1)
    return torch.where(mask, enc_lens[idx], 0).sum()


def _to_host(tensors) -> list[np.ndarray]:
    """Integer tensors of one device -> numpy arrays (int64), in one copy."""
    flat = fetch(torch.cat([t.reshape(-1).to(torch.int64) for t in tensors])).numpy()
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out


def _code_tables(codes, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each canonical code's (codes, lengths) as int64 tensors on ``device``,
    in one upload."""
    flat = np.concatenate([np.concatenate([c.codes, c.lengths]).astype(np.int64) for c in codes])
    dev = upload_pageable(torch.from_numpy(flat), device)
    out, off = [], 0
    for c in codes:
        out.append((dev[off:off + c.n], dev[off + c.n:off + 2 * c.n]))
        off += 2 * c.n
    return out


def _train_codes(mn_np, mx_np, hist_np, direct_histogram) -> list:
    """Per-frame canonical codes from the fetched statistics, on the host.

    Each frame's alphabet is its bucketed bounds; its training histogram is
    the slice of the full-range one, or ``direct_histogram(t, lo, hi)``
    where the bounds fall outside it.
    """
    codes = []
    for t in range(len(mn_np)):
        lo, hi = bucket_bounds(int(mn_np[t]), int(mx_np[t]))
        if _HIST_LO <= lo and hi <= _HIST_HI:
            hist = hist_np[t, lo - _HIST_LO:hi - _HIST_LO]
        else:
            hist = direct_histogram(t, lo, hi)
        pmf = pmf_from_histogram(hist)
        codes.append(HuffmanCoder(lower_bound=lo).train(pmf.astype(np.float64)).code)
    return codes


def _sized_buckets_ok(gb_np, in_group_np, wpg: int, bw: int) -> bool:
    """True when the speculative pack buckets held a frame's content.

    Group bits and block offsets are exact whatever the word buffers
    truncate, so the words need not be read: every group must fit its
    ``wpg`` words and every block its ``bw``-word deposit buffer.
    ``in_group_np`` holds in-group bit offsets.
    """
    gb = np.asarray(gb_np).astype(np.int64)
    if gb.size == 0:
        return True
    if int(gb.max()) > wpg * 32:
        return False
    ig = np.asarray(in_group_np).astype(np.int64).reshape(-1, PACK_GROUP)
    ends = np.concatenate([ig[:, 1:], gb.reshape(-1, 1)], axis=1)
    return int(((ends - ig).max(initial=0) + 31) // 32) <= bw


def _in_group(boffs_np, stride: int) -> np.ndarray:
    """Global bit offsets at ``stride`` words per group -> in-group offsets."""
    b = np.asarray(boffs_np).astype(np.int64).reshape(-1)
    base = np.arange(b.size // PACK_GROUP, dtype=np.int64) * (stride * 32)
    return b - np.repeat(base, PACK_GROUP)


def _pack_frames(frames) -> list:
    """Grouped-pack frames, each under its own canonical code.

    ``frames``: ``(buf, valid, cap, code)`` per frame, on one device; ``cap``
    is a symbol-capacity bucket holding every block. Packs speculatively
    into the small ``ADAPTIVE_WPG``/``ADAPTIVE_BW`` buckets, reads every
    frame's group bits, offsets and counts in one copy, re-packs full-stride
    the frames that overflowed, and reads the used words of every frame in
    one copy. Returns ``[(GroupedSection, payload bits)]``; the bytes are the
    same whichever packer a frame took.
    """
    wpg, bw = tf.ADAPTIVE_WPG, tf.ADAPTIVE_BW
    tables = _code_tables([code for *_, code in frames], frames[0][0].device)
    padded = [_pad_blocks(buf, valid)[:2] for buf, valid, _, _ in frames]
    packs = [list(tf.pack_symbols_grouped_sized(bufp[:, :cap], validp, codes, lens,
                                                code.lower_bound, wpg, bw)[:3])
             for (bufp, validp), (_, _, cap, code), (codes, lens) in zip(padded, frames, tables)]
    strides = [wpg] * len(frames)
    side = _to_host([x for (_, gb, offs), (_, validp) in zip(packs, padded)
                     for x in (gb, offs, validp)])
    side = [side[3 * k:3 * k + 3] for k in range(len(frames))]  # group bits, offsets, counts
    for k, (gb_np, offs_np, _) in enumerate(side):
        if not _sized_buckets_ok(gb_np, _in_group(offs_np, wpg), wpg, bw):
            (bufp, validp), (codes, lens) = padded[k], tables[k]
            packs[k] = list(pack_symbols_grouped(bufp, validp, codes, lens,
                                                 frames[k][3].lower_bound)[:3])
            strides[k] = GROUP_WORDS
            side[k][:2] = _to_host(packs[k][1:3])
    wmaxes = [packer_wmax(gb_np, stride) for (gb_np, _, _), stride in zip(side, strides)]
    words = _to_host([p[0][:, :w] for p, w in zip(packs, wmaxes)])
    return [(GroupedSection.from_packer_sliced(w_np, gb_np, offs_np, counts_np, PACK_GROUP,
                                               stride, wmax), int(gb_np.sum()))
            for w_np, (gb_np, offs_np, counts_np), stride, wmax
            in zip(words, side, strides, wmaxes)]


def _pack_section(buf, valid, code):
    """One frame's grouped section under a canonical code: (GroupedSection,
    exact payload bits)."""
    return _pack_frames([(buf, valid, buf.shape[1], code)])[0]


def _pack_flat_section(flat_syms, code):
    """Pack a flat symbol stream (motion indices) as 64-symbol blocks, on
    the host through the C++ engine (numpy where there is no g++).

    The group layout (MSB-first blocks concatenated per 16-block group,
    word-aligned group starts, u16 in-group offsets, width-sliced words) is
    the device packer's, byte for byte. Returns (GroupedSection, bits).
    """
    S = 64
    flat = np.asarray(flat_syms).reshape(-1)
    M = int(flat.size)
    n_blocks = max(-(-M // S), 1)
    n_blocks = -(-n_blocks // PACK_GROUP) * PACK_GROUP
    padded = np.zeros(n_blocks * S, dtype=np.int64)
    padded[:M] = flat
    counts = np.clip(M - np.arange(n_blocks) * S, 0, S).astype(np.int32)

    idx = np.clip(padded - code.lower_bound, 0, code.lengths.size - 1)
    blk_codes = code.codes[idx].astype(np.uint32).reshape(n_blocks, S)
    blk_lens = code.lengths[idx].astype(np.int32).reshape(n_blocks, S)
    mask = np.arange(S)[None, :] < counts[:, None]
    blk_lens = np.where(mask, blk_lens, 0)
    block_bits = blk_lens.sum(axis=1, dtype=np.int64)

    G = n_blocks // PACK_GROUP
    group_bits = block_bits.reshape(G, PACK_GROUP).sum(axis=1)
    wmax = packer_wmax(group_bits, GROUP_WORDS)
    words = np.zeros((G, wmax), dtype=np.uint32)
    for g in range(G):
        sl = slice(g * PACK_GROUP * S, (g + 1) * PACK_GROUP * S)
        w, _ = native.pack_bits(blk_codes.reshape(-1)[sl], blk_lens.reshape(-1)[sl])
        words[g, : min(w.size, wmax)] = w[:wmax]
    bb = block_bits.reshape(G, PACK_GROUP)
    in_group = (np.cumsum(bb, axis=1) - bb).reshape(-1)
    section = GroupedSection(
        words=words,
        group_word_counts=((group_bits + 31) // 32).astype(np.uint32),
        block_offsets=in_group.astype(np.uint16),
        block_counts=counts.astype(np.uint8),
        group_size=PACK_GROUP,
        words_per_group=wmax,
    )
    return section, int(group_bits.sum())


def _pframe_charge(mv, code, mv_code, policy: str) -> int:
    """A P-frame's bits beside its residual payload: the motion field's code
    lengths, plus the serialized codebook (8-byte header + lengths, + 12)
    under the ``adaptive`` policy."""
    bits = int(np.sum(mv_code.lengths[np.asarray(mv).reshape(-1)]))
    if policy == "adaptive":
        bits += 8 * ((8 + code.n) + 12)
    return bits


def _adaptive_payload(q: float, eob: int, sr: int, policy: str, shape, codes, packed, mvs_np,
                      mv_code) -> bytes:
    """Serialize a GOP: per-frame codes and ``(section, bits)``, and the
    ``[T, hb, wb]`` motion fields (frame 0's is not coded)."""
    T = len(codes)
    frame_bits = np.zeros(T, dtype=np.uint64)
    frames = []
    for t, (code, (section, bits)) in enumerate(zip(codes, packed)):
        if t > 0:
            bits += _pframe_charge(mvs_np[t], code, mv_code, policy)
        frame_bits[t] = bits
        frames.append((Codebook(code.lower_bound, np.asarray(code.lengths, dtype=np.uint8)),
                       section))
    mv_section, _ = _pack_flat_section(np.asarray(mvs_np[1:]).reshape(-1).astype(np.int32),
                                       mv_code)
    return AdaptiveVideoPayload(
        quantization_scale=float(q),
        eob=int(eob),
        search_range=int(sr),
        policy=1 if policy == "adaptive" else 0,
        shape=tuple(int(s) for s in shape),
        payload_bits=int(frame_bits.sum()),
        frame_bits=frame_bits,
        mv_codebook=Codebook(0, np.asarray(mv_code.lengths, dtype=np.uint8)),
        mv=mv_section,
        frames=frames,
    ).to_bytes()


def _uniform_mv_code(search_range: int):
    n = (2 * search_range + 1) ** 2
    return HuffmanCoder(lower_bound=0).train(np.full(n, 1.0 / n))


def reference_state(codec) -> dict:
    """A ``VideoCodec``'s state as plain numbers and numpy arrays, the input
    of :meth:`VideoCodec.from_reference_state`. Reads the JAX package's
    codec and the port's alike (the same attribute names), also between
    frames of a sequence."""
    def intra(c):
        return None if c.huffman is None or c.huffman.code is None else intra_reference_state(c)

    recon = codec.decoder_recon
    return {
        "codebook_policy": codec.codebook_policy,
        "quantization_scale": float(codec.quantization_scale),
        "end_of_block": int(codec.end_of_block),
        "search_range": int(codec.search_range),
        "verify_entropy": bool(codec.verify_entropy),
        "intra_codec": intra(codec.intra_codec),
        "residual_codec": intra(codec.residual_codec),
        "motion_lengths": (np.asarray(codec.motion_huffman.code.lengths)
                           if codec._motion_trained else None),
        "decoder_recon": None if recon is None else _numpy(recon).astype(np.float32),
    }


class VideoCodec:
    """The course reference's hybrid video codec; every stage runs on ``device``."""

    def __init__(
        self,
        quantization_scale: float = 1.0,
        bounds=None,
        end_of_block: int = 4000,
        block_shape=(8, 8),
        search_range: int = 4,
        codebook_policy: str = "per-frame",
        verify_entropy: bool = False,
        device: str | torch.device = "cuda",
    ):
        """``verify_entropy=True`` makes the per-frame policies run the full
        entropy encode and decode of every residual plane instead of
        rebuilding it from the quantized coefficients; bits and
        reconstructions are the same either way."""
        if codebook_policy not in CODEBOOK_POLICIES:
            raise ValueError(f"codebook_policy must be one of {CODEBOOK_POLICIES}")
        self.verify_entropy = bool(verify_entropy)
        self.quantization_scale = float(quantization_scale)
        self.bounds = bounds
        self.end_of_block = int(end_of_block)
        self.block_shape = tuple(block_shape)
        self.search_range = int(search_range)
        self.codebook_policy = codebook_policy
        self.device = torch.device(device)

        codec_cls = IntraCodecAdaptive if codebook_policy == "adaptive" else IntraCodec
        self.intra_codec = codec_cls(quantization_scale, bounds, end_of_block, block_shape,
                                     device=self.device)
        self.residual_codec = codec_cls(quantization_scale, bounds, end_of_block, block_shape,
                                        device=self.device)
        self.motion_huffman = HuffmanCoder(lower_bound=0)
        self._motion_trained = False
        self.decoder_recon: torch.Tensor | None = None

    @classmethod
    def from_reference_state(cls, state: dict, device: str | torch.device = "cuda"):
        """A codec that continues where a JAX or port ``VideoCodec`` stands.

        ``state`` (see :func:`reference_state`) holds the policy, q, EOB,
        search range, the intra and residual codecs' ``reference_state``
        (or None where untrained), the motion code's lengths (or None) and
        the decoder's reconstruction (or None).
        """
        codec = cls(state["quantization_scale"], end_of_block=state["end_of_block"],
                    search_range=state["search_range"],
                    codebook_policy=state["codebook_policy"],
                    verify_entropy=state.get("verify_entropy", False), device=device)
        intra_cls = type(codec.intra_codec)
        for name in ("intra_codec", "residual_codec"):
            if state[name] is not None:
                setattr(codec, name, intra_cls.from_reference_state(state[name], device))
        if state["motion_lengths"] is not None:
            codec.motion_huffman.code = canonical_from_lengths(
                np.asarray(state["motion_lengths"], dtype=np.int32), 0)
            codec._motion_trained = True
        if state["decoder_recon"] is not None:
            codec.decoder_recon = torch.from_numpy(
                np.ascontiguousarray(state["decoder_recon"], dtype=np.float32)).to(codec.device)
        return codec

    # ------------------------------------------------------------ plumbing

    def _require_fp32(self):
        if self.device.type == "cuda":
            require_full_fp32()

    def _upload(self, x) -> torch.Tensor:
        """Numpy or tensor -> the device as float32 (uint8 uploads as uint8)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device).to(torch.float32).contiguous()

    def _require_mv_code(self):
        if not self._motion_trained:
            self.motion_huffman = _uniform_mv_code(self.search_range)
            self._motion_trained = True
        return self.motion_huffman.code

    def _code_motion(self, mv_grid: np.ndarray):
        """Huffman-code the packed motion field -> (words, bits, decoded field)."""
        self._require_mv_code()
        flat = mv_grid.reshape(-1)
        words, bits = self.motion_huffman.encode(flat)
        decoded = self.motion_huffman.decode(words, flat.size).reshape(mv_grid.shape)
        return words, bits, decoded.astype(np.int32)

    def _code_residual_plane(self, plane):
        """Train per the policy, encode and decode one plane -> (recon, bits)."""
        codec = self.residual_codec
        policy = self.codebook_policy
        if policy == "adaptive":
            packed, bitsize = codec.intra_encode(plane, is_source_rgb=False)
            codebook_bits = 8 * (packed[0] + 12)  # blob + (len, num_symbols) header
            recon = codec.intra_decode(packed, tuple(plane.shape))
            return recon, int(bitsize) + codebook_bits
        if policy == "per-frame" or codec.huffman is None:
            codec.train_huffman_from_image(plane, is_source_rgb=False)
        # first-p-frame reuses the codebook; the pack clamps out-of-alphabet
        # symbols to the alphabet's edge, which is the nearest trained value
        verify = policy == "first-p-frame" or self.verify_entropy
        recon, _, bitsize = codec.encode_decode(plane, is_source_rgb=False, verify_entropy=verify)
        return recon, int(bitsize)

    # ------------------------------------------------------------ facade

    def encode_decode(self, frame, frame_num: int = 0):
        """Encode and decode one RGB frame -> (reconstruction, bitstream, bits).

        Frame 0 is an I-frame; later frames are P-frames predicted from the
        decoder's reconstruction of the previous one. Only luma is coded;
        chroma passes through. The reconstruction is ``[H, W, 3]`` uint8 on
        the device (``ycbcr2rgb`` of the clipped luma and the source
        chroma, truncated). ``bitstream`` is a self-contained IVC1 blob
        that :meth:`decode_frame_payload` decodes; ``bits`` keeps the
        reference's rate accounting (residual and motion code lengths, plus
        the codebook charge under the ``adaptive`` policy).
        """
        ycbcr = rgb2ycbcr(self._upload(frame))
        y = ycbcr[..., 0].contiguous()

        if frame_num == 0:
            if self.codebook_policy != "adaptive":
                self.intra_codec.train_huffman_from_image(y, is_source_rgb=False)
                recon_y, _, residual_bits = self.intra_codec.encode_decode(
                    y, is_source_rgb=False, verify_entropy=self.verify_entropy)
            else:
                packed, residual_bits = self.intra_codec.intra_encode(y, is_source_rgb=False)
                recon_y = self.intra_codec.intra_decode(packed, tuple(y.shape))
            motion_bits = 0
            bitstream = self._frame_blob(y, self.intra_codec, residual_bits)
        else:
            ref_y = self.decoder_recon
            mv = motion_search(ref_y, y, self.search_range)
            _, motion_bits, mv_decoded = self._code_motion(mv.cpu().numpy())
            pred = motion_compensate(ref_y, torch.from_numpy(mv_decoded), self.search_range)
            residual = y - pred
            recon_residual, residual_bits = self._code_residual_plane(residual)
            recon_y = pred + recon_residual
            bitstream = self._frame_blob(residual, self.residual_codec,
                                         int(residual_bits) + int(motion_bits), mv=mv_decoded)
        self.decoder_recon = recon_y.contiguous()

        recon_ycbcr = ycbcr.clone()
        recon_ycbcr[..., 0] = recon_y.clamp(0, 255)
        recon_rgb = ycbcr2rgb(recon_ycbcr).to(torch.uint8)
        return recon_rgb, bitstream, int(residual_bits) + int(motion_bits)

    def _frame_blob(self, plane, codec_obj, bits: int, mv=None) -> bytes:
        """One facade frame as a self-contained IVC1 blob: an I-frame
        (``mv is None``) as a T=1 ``AdaptiveVideoPayload``, a P-frame as a
        ``PFramePayload``, under the code and tables ``codec_obj`` used."""
        code = codec_obj.huffman.code
        x, orig_shape = codec_obj._prepare(plane, is_source_rgb=False)
        _, inv_qt = codec_obj._tables(1)
        buf, valid, _ = forward_symbolize(x, inv_qt, self.end_of_block)
        section, _ = _pack_section(buf, valid, code)
        cb = Codebook(code.lower_bound, np.asarray(code.lengths, dtype=np.uint8))
        mv_code = self._require_mv_code()
        mv_cb = Codebook(0, np.asarray(mv_code.lengths, dtype=np.uint8))
        H, W = orig_shape[0], orig_shape[1]
        if mv is None:
            mv_section, _ = _pack_flat_section(np.zeros(0, np.int32), mv_code)
            return AdaptiveVideoPayload(
                quantization_scale=self.quantization_scale,
                eob=self.end_of_block,
                search_range=self.search_range,
                policy=1 if self.codebook_policy == "adaptive" else 0,
                shape=(1, H, W),
                payload_bits=int(bits),
                frame_bits=np.asarray([bits], dtype=np.uint64),
                mv_codebook=mv_cb,
                mv=mv_section,
                frames=[(cb, section)],
            ).to_bytes()
        mv_section, _ = _pack_flat_section(np.asarray(mv).reshape(-1), mv_code)
        return PFramePayload(
            quantization_scale=self.quantization_scale,
            eob=self.end_of_block,
            search_range=self.search_range,
            shape=(H, W),
            payload_bits=int(bits),
            mv_codebook=mv_cb,
            mv=mv_section,
            residual_codebook=cb,
            residual=section,
        ).to_bytes()

    @staticmethod
    def decode_frame_payload(blob: bytes, recon_prev=None, device: str | torch.device = "cuda"):
        """One facade frame's luma plane from its blob alone, as a float32
        tensor on ``device``.

        I-frame blobs decode standalone; P-frame blobs also need the
        previous reconstruction (decoder state, not encoder state: the
        codebooks, symbol counts and motion field all come from the bytes).
        Raises ``ValueError`` on a blob that is not a frame payload or does
        not decode.
        """
        if len(blob) < 7 or blob[:4] != MAGIC:
            raise ValueError("not an IVC1 container")
        kind = blob[6]
        if kind == KIND_VIDEO_ADAPTIVE:
            recons, oks = VideoCodec.decode_from_container(blob, return_device=True,
                                                           device=device)
            if not bool(oks.all()):
                raise ValueError("corrupt I-frame residual stream")
            return recons[0]
        if kind != KIND_PFRAME:
            raise ValueError(f"not a frame payload (kind={kind})")
        if recon_prev is None:
            raise ValueError("P-frame decode needs the previous reconstruction")
        p = PFramePayload.from_bytes(blob)
        H, W = p.shape
        sr, eob = p.search_range, p.eob
        if H % 8 or W % 8:
            # the encoder's P-frames are whole 8x8 blocks; anything else is
            # a corrupt header
            raise ValueError(f"P-frame dims must be multiples of 8, got ({H}, {W})")
        dev = torch.device(device)
        if dev.type == "cuda":
            require_full_fp32()
        hb, wb = H // 8, W // 8
        n_real = hb * wb
        if p.mv.block_counts.size * 64 < n_real or p.residual.block_counts.size < n_real:
            raise ValueError("P-frame sections hold fewer blocks than the frame needs")

        mv_views = p.mv.device_views(dev)
        mv_tables = decode_tables(p.mv_codebook.canonical(), dev)
        code = p.residual_codebook.canonical()
        views, tables = p.residual.device_views(dev), decode_tables(code, dev)
        ref = torch.as_tensor(recon_prev).to(device=dev, dtype=torch.float32)
        qt = upload(quant_table_zigzag(p.quantization_scale, 1), dev)

        mv = _decode_flat(p.mv, mv_views, mv_tables)[:n_real].reshape(hb, wb)
        rrec, ok = _decode_residual(code.lower_bound, views, tables,
                                    int(p.residual.block_counts.max(initial=0)), (hb, wb), eob, qt)
        if not bool(ok):
            raise ValueError("corrupt P-frame residual stream")
        return motion_compensate(ref, mv, sr) + rrec

    # ------------------------------------------------------------ container

    def _per_frame_codes(self, outs):
        """Fetch the scan's statistics in one copy and build every frame's
        code on the host -> (codes, largest counts, motion fields)."""
        bufs, valids, mn, mx, hist, mvs, _, vmax = outs
        mn_np, mx_np, hist_np, mvs_np, vmax_np = _to_host([mn, mx, hist, mvs, vmax])
        with span("ivc.adaptive.codebooks"):
            codes = _train_codes(mn_np, mx_np, hist_np,
                                 lambda t, lo, hi: symbol_histogram(bufs[t], valids[t], lo, hi))
        return codes, vmax_np, mvs_np

    def encode_to_container(self, frames_y) -> bytes:
        """Encode a ``[T, H, W]`` luma sequence (H, W multiples of 8) into a
        self-contained IVC1 ``AdaptiveVideoPayload`` with per-frame residual
        codebooks (policies ``per-frame`` and ``adaptive``; ``first-p-frame``
        streams serialize through ``FusedVideoCodec``). The bytes are the
        JAX package's; :meth:`decode_from_container` gives the encoder's
        reconstruction chain back from them alone."""
        if self.codebook_policy not in ("per-frame", "adaptive"):
            raise ValueError(
                "the adaptive container serializes per-frame codebooks; use "
                "policy 'per-frame' or 'adaptive' (first-p-frame streams "
                "serialize via FusedVideoCodec.encode_to_container)"
            )
        with span("ivc.adaptive.encode"):
            y = self._upload(frames_y)
            T, H, W = y.shape
            if H % 8 or W % 8:
                raise ValueError("container path needs frame dims divisible by 8")
            self._require_fp32()
            qt, inv_qt = self.intra_codec._tables(1)
            mv_code = self._require_mv_code()

            with span("ivc.adaptive.scan"):
                outs = _pframe_scan(y, range(T), inv_qt, qt, self.search_range,
                                    self.end_of_block)
            codes, vmax_np, mvs_np = self._per_frame_codes(outs)
            bufs, valids, recons = outs[0], outs[1], outs[6]
            with span("ivc.adaptive.pack"):
                packed = _pack_frames([(bufs[t], valids[t],
                                        cap_slice(int(vmax_np[t]), BLOCK_CAP), codes[t])
                                       for t in range(T)])
            self.decoder_recon = recons[-1]
            with span("ivc.adaptive.serialize"):
                return _adaptive_payload(self.quantization_scale, self.end_of_block,
                                         self.search_range, self.codebook_policy, (T, H, W),
                                         codes, packed, mvs_np, mv_code)

    @classmethod
    def decode_from_container(cls, blob: bytes, return_device: bool = False,
                              device: str | torch.device = "cuda"):
        """Reconstruct ``[T, H, W]`` float32 luma from an adaptive container
        alone, on ``device``.

        The sections and tables are uploaded without blocking the host,
        every frame's entropy decode (one canonical walk kernel launch for
        the MV section and one a frame on the card) and reconstruction is
        enqueued with no host synchronisation, and the validity flags are
        read once at the end. ``return_device=True`` returns ``(tensor [T,
        H, W] on the device, ok flags)`` without the host copy or any host
        synchronisation; otherwise a numpy array, and a corrupt frame raises
        ``ValueError``.
        """
        with span("ivc.adaptive.decode"):
            with span("ivc.decode.parse"):
                p = AdaptiveVideoPayload.from_bytes(blob)
            T, H, W = p.shape
            sr, eob = p.search_range, p.eob
            dev = torch.device(device)
            if dev.type == "cuda":
                require_full_fp32()
            hb, wb = H // 8, W // 8
            hp, wp = -(-H // 8), -(-W // 8)  # a T=1 facade I-frame may be edge-padded
            M = (T - 1) * hb * wb
            if T > 1 and (H % 8 or W % 8):
                raise ValueError(f"P-frame dims must be multiples of 8, got ({H}, {W})")
            if p.mv.block_counts.size * 64 < M:
                raise ValueError("MV section holds fewer symbols than the GOP needs")
            if any(s.block_counts.size < hp * wp for _, s in p.frames):
                raise ValueError("a frame section holds fewer blocks than the frame needs")

            with span("ivc.decode.tables"):
                qt = upload(quant_table_zigzag(p.quantization_scale, 1), dev)
                if M:
                    mv_tables = decode_tables(p.mv_codebook.canonical(), dev)
                codes = [cb.canonical() for cb, _ in p.frames]
                tables = [decode_tables(code, dev) for code in codes]
            with span("ivc.decode.upload"):
                if M:
                    mv_views = p.mv.device_views(dev)
                views = [section.device_views(dev) for _, section in p.frames]

            with span("ivc.decode.enqueue"):
                if M:
                    mvs = _decode_flat(p.mv, mv_views, mv_tables)[:M].reshape(T - 1, hb, wb)
                recons, oks, recon = [], [], None
                for t, ((_, section), code) in enumerate(zip(p.frames, codes)):
                    rrec, ok = _decode_residual(code.lower_bound, views[t], tables[t],
                                                int(section.block_counts.max(initial=0)),
                                                (hp, wp), eob, qt)
                    oks.append(ok)
                    rrec = rrec[:H, :W]
                    recon = rrec if t == 0 else motion_compensate(recon, mvs[t - 1], sr) + rrec
                    recons.append(recon)
                recons, oks = torch.stack(recons), torch.stack(oks)
            if return_device:
                return recons, oks
            for t, ok in enumerate(fetch(oks).tolist()):
                if not ok:
                    raise ValueError(f"frame {t}: corrupt residual stream")
            return fetch(recons).numpy()

    # ------------------------------------------------------------ sequences

    def encode_decode_sequence(self, frames, gop_size: int | None = None):
        """Encode a whole RGB sequence through the facade -> (reconstructions
        ``[T, H, W, 3]`` uint8 on the device, bits per frame int64);
        ``gop_size`` restarts an I-frame every N frames."""
        recons, bits = [], []
        for t in range(len(frames)):
            local_t = t if gop_size is None else t % gop_size
            recon, _, bitsize = self.encode_decode(frames[t], frame_num=local_t)
            recons.append(recon)
            bits.append(bitsize)
        return torch.stack(recons), np.asarray(bits, dtype=np.int64)

    def encode_decode_sequence_checkpointed(self, frames, gop_size: int, checkpointer):
        """GOP-granular fault-tolerant encode: GOPs the checkpointer holds are
        loaded, the rest are encoded and saved atomically, so a crashed run
        resumes by re-encoding only its unfinished GOPs. Returns what
        :meth:`encode_decode_sequence` returns."""
        T = len(frames)
        recons, bits = [], np.zeros(T, dtype=np.int64)
        for g in range(-(-T // gop_size)):
            lo, hi = g * gop_size, min((g + 1) * gop_size, T)
            cached = checkpointer.load_gop(g)
            if cached is not None:
                # GOPs open with an I-frame: no state crosses a GOP boundary
                _, gop_recons, gop_bits = cached
                recons.append(torch.from_numpy(gop_recons).to(self.device))
                bits[lo:hi] = gop_bits
                continue
            gop_recons, gop_bits = [], []
            for t in range(lo, hi):
                recon, _, b = self.encode_decode(frames[t], frame_num=t - lo)
                gop_recons.append(recon)
                gop_bits.append(b)
            recons.append(torch.stack(gop_recons))
            bits[lo:hi] = gop_bits
            checkpointer.save_gop(g, b"", recons[-1].cpu().numpy(),
                                  np.asarray(gop_bits, dtype=np.int64))
        return torch.cat(recons), bits

    def encode_decode_sequence_pipelined(self, frames, gop_size: int | None = None):
        """Per-frame-adaptive sequence coding with the same rates and
        reconstructions as :meth:`encode_decode_sequence` (``per-frame``
        and ``adaptive`` policies), restructured so the device never waits
        on the host: every frame's device work runs first (the closed-loop
        reconstruction goes through the quantized residual, never the
        entropy stage), then the host builds each frame's code from one
        fetch of the statistics, and the exact rates come back in one more
        fetch. Frames must be multiples of 8 in both dimensions."""
        if self.codebook_policy not in ("per-frame", "adaptive"):
            raise ValueError(
                "pipelined sequence coding retrains per frame; use policy "
                "'per-frame' or 'adaptive' (first-p-frame has no per-frame "
                "tree build to pipeline; use FusedVideoCodec)"
            )
        ycbcr = rgb2ycbcr(self._upload(frames))
        T, H, W = ycbcr.shape[:3]
        if H % 8 or W % 8:
            raise ValueError("pipelined path needs frame dims divisible by 8")
        self._require_fp32()
        y = ycbcr[..., 0].contiguous()
        qt, inv_qt = self.intra_codec._tables(1)
        mv_code = self._require_mv_code()

        local_ts = np.arange(T) if gop_size is None else np.arange(T) % gop_size
        outs = _pframe_scan(y, local_ts, inv_qt, qt, self.search_range, self.end_of_block)
        codes, vmax_np, mvs_np = self._per_frame_codes(outs)
        bufs, valids, recons = outs[0], outs[1], outs[6]
        tables = _code_tables(codes, self.device)
        bits_dev = [
            _masked_code_bits(bufs[t, :, :cap_slice(int(vmax_np[t]), bufs.shape[2])], valids[t],
                              tables[t][1], codes[t].lower_bound)
            for t in range(T)
        ]
        bits = _to_host([torch.stack(bits_dev)])[0]
        for t in range(T):
            if local_ts[t] > 0:
                bits[t] += _pframe_charge(mvs_np[t], codes[t], mv_code, self.codebook_policy)

        recon_ycbcr = torch.cat([recons.clamp(0, 255)[..., None], ycbcr[..., 1:]], dim=-1)
        # the truncating cast is the facade's
        return ycbcr2rgb(recon_ycbcr).to(torch.uint8), bits.astype(np.int64)


def _decode_flat(section: GroupedSection, views, tables) -> torch.Tensor:
    """A flat 64-symbol-block stream (motion indices) -> its symbols, 1-D,
    zero past each block's count."""
    words, offs, counts = views
    sym = decode_blocks_device(words, offs, counts, tables, 64,
                               max_count=int(section.block_counts.max(initial=0)))
    in_count = torch.arange(64, device=sym.device)[None, :] < counts[:, None]
    return torch.where(in_count, sym, 0).reshape(-1)


def _decode_residual(lower: int, views, tables, vmax: int, grid, eob: int, qt):
    """One frame's residual section (its device views and decode tables)
    -> (``[hp * 8, wp * 8]`` residual plane, ok flag) on the views' device,
    for a ``grid`` of ``(hp, wp)`` blocks. The walk's depth is the bucket
    of ``vmax``, the sidecar's largest block count."""
    words, offs, counts = views
    n_real = grid[0] * grid[1]
    cap = cap_slice(max(vmax, 1), BLOCK_CAP)
    sym_idx = decode_blocks_device(words, offs, counts, tables, cap, max_count=vmax)
    in_count = torch.arange(cap, device=words.device)[None, :] < counts[:, None]
    syms = torch.where(in_count, sym_idx + lower, 0)[:n_real]
    blocks, ok = zerorun_decode_blocks(syms, counts[:n_real], 64, eob)
    return inverse_reconstruct(blocks, qt, (grid[0] * 8, grid[1] * 8, 1))[:, :, 0], ok
