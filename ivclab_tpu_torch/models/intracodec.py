"""JPEG-style still-image intra codec, block-parallel on the codec's device.

Port of ``ivclab_tpu/models/intracodec.py`` (the course reference's
IntraCodec and IntraCodecAdaptive):

  encode: rgb2ycbcr -> edge pad to multiples of 8 -> one [N,64]x[64,64]
          f32 matmul (DCT with the zig-zag folded in) -> quantize ->
          per-block zero-run -> full-alphabet Huffman pack (one flat stream,
          or 16-block word-aligned groups for the container)
  decode: block-parallel canonical Huffman walk -> zero-run decode ->
          dequantize + IDCT matmul -> unpatch -> crop -> ycbcr2rgb

Images come in as numpy arrays or tensors; reconstructions come out as
float32 tensors on the codec's ``device``; bit streams and symbol streams
are host numpy arrays (the C++ engine's inputs); containers are ``bytes``.
Every integer (symbols, code lengths, words, bit offsets) and every
container byte equals the JAX package's for the same image.

Differences from the course reference, kept from the JAX package:
- ``num_symbols`` travels in the container; the attribute is kept for the
  reference's side-channel API.
- Grayscale inputs are quantized with the luminance table only.
- Training bounds are bucketed to multiples of 64 (the reference's +/-20
  margin is kept inside the bucket).

A symbol outside the trained alphabet is clamped to its edge by the pack,
as in the JAX package: the stream then decodes to another symbol. A
codebook trained with ``bounds=codec.full_bounds()`` spans every symbol an
8-bit image can produce, so no image is clamped; its bytes differ from the
default training's (and from the JAX package's, which has no such bounds).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ivclab_tpu_torch.entropy.codebook import CanonicalCode, canonical_from_lengths
from ivclab_tpu_torch.entropy.huffman import HuffmanCoder
from ivclab_tpu_torch.entropy.stats import pmf_from_histogram
from ivclab_tpu_torch.ops.bitpack import decode_blocks_device, decode_tables
from ivclab_tpu_torch.ops.color import _RGB2YCBCR, _YCBCR_OFFSET, rgb2ycbcr, ycbcr2rgb
from ivclab_tpu_torch.ops.dct import dct2_kron_matrix, require_full_fp32
from ivclab_tpu_torch.ops.quant import quant_table_zigzag
from ivclab_tpu_torch.ops.transform import (
    GROUP_WORDS,
    PACK_GROUP,
    decode_grouped_planes,
    forward_symbolize,
    inverse_reconstruct,
    pack_symbols,
    pack_symbols_grouped,
    symbol_histogram,
)
from ivclab_tpu_torch.ops.zerorun import BLOCK_CAP, compact_symbols, zerorun_decode_stream
from ivclab_tpu_torch.runtime import container as ct
from ivclab_tpu_torch.runtime.trace import fetch, span
from ivclab_tpu_torch.utils.shape import upload

_BOUND_BUCKET = 64
_SAFETY_MARGIN = 20  # matches the course reference's +/-20 margin


def _sym_min_max(buf: torch.Tensor, valid_len: torch.Tensor):
    """(min, max) over the valid symbols of per-block buffers."""
    pos = torch.arange(buf.shape[1], device=buf.device)
    mask = pos[None, :] < valid_len[:, None]
    mn = torch.where(mask, buf, 2**31 - 1).min()
    mx = torch.where(mask, buf, -(2**31 - 1)).max()
    return mn, mx


def bucket_bounds(mn: int, mx: int, margin: int = _SAFETY_MARGIN, bucket: int = _BOUND_BUCKET):
    lo = ((mn - margin) // bucket) * bucket
    hi = -((-(mx + margin + 1)) // bucket) * bucket
    return int(lo), int(hi)


def reference_state(codec) -> dict:
    """A trained ``IntraCodec``'s state as plain numbers and numpy arrays,
    the input of :meth:`IntraCodec.from_reference_state`. Reads the JAX
    package's codec and the port's alike (the same attribute names)."""
    code = codec.huffman.code
    return {
        "quantization_scale": float(codec.quantization_scale),
        "end_of_block": int(codec.end_of_block),
        "bounds": tuple(int(b) for b in codec.bounds),
        "codebook": (int(code.lower_bound), np.asarray(code.lengths)),
    }


def _pad_blocks(buf: torch.Tensor, valid_len: torch.Tensor, multiple: int = PACK_GROUP):
    """Pad the block axis to a multiple of the pack group (empty blocks)."""
    N = buf.shape[0]
    pad = (-N) % multiple
    if pad:
        buf = torch.cat([buf, buf.new_zeros((pad, buf.shape[1]))])
        valid_len = torch.cat([valid_len, valid_len.new_zeros(pad)])
    return buf, valid_len, N


class IntraCodec:
    """The course reference's intra codec facade; every stage runs on ``device``."""

    def __init__(
        self,
        quantization_scale: float = 1.0,
        bounds=None,
        end_of_block: int = 4000,
        block_shape=(8, 8),
        device: str | torch.device = "cuda",
    ):
        self.quantization_scale = float(quantization_scale)
        self.bounds = bounds
        self.end_of_block = int(end_of_block)
        self.block_shape = tuple(block_shape)
        self.device = torch.device(device)
        self.huffman: HuffmanCoder | None = None
        self.num_symbols: int | None = None
        self._qt_cache: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    @classmethod
    def from_reference_state(cls, state: dict, device: str | torch.device = "cuda"):
        """A codec computing what a trained JAX ``IntraCodec`` computes.

        ``state`` holds plain numbers and numpy arrays:
        ``quantization_scale``, ``end_of_block``, ``bounds`` and
        ``codebook`` as ``(lower_bound, lengths)``; :func:`reference_state`
        takes it from a trained codec of either package.
        """
        codec = cls(state["quantization_scale"], end_of_block=state["end_of_block"],
                    device=device)
        lower, lengths = state["codebook"]
        codec._install_code(canonical_from_lengths(np.asarray(lengths, dtype=np.int32), int(lower)))
        bounds = state.get("bounds")
        codec.bounds = None if bounds is None else tuple(int(b) for b in bounds)
        return codec

    # ------------------------------------------------------------ plumbing

    def _tables(self, C: int):
        """(table, reciprocal table) ``[C, 64]`` on the device, scan order."""
        if C not in self._qt_cache:
            qt = quant_table_zigzag(self.quantization_scale, max(C, 1))
            self._qt_cache[C] = (upload(qt, self.device),
                                 upload((1.0 / qt).astype(np.float32), self.device))
        return self._qt_cache[C]

    def _prepare(self, img, is_source_rgb: bool):
        """-> (``[H8, W8, C]`` float32 YCbCr on the device, original shape)."""
        if self.device.type == "cuda":
            require_full_fp32()
        if not isinstance(img, torch.Tensor):  # upload as given (uint8 is 4x smaller)
            img = upload(img, self.device)
        x = img.to(self.device).to(torch.float32)
        orig_shape = tuple(int(s) for s in x.shape)
        if is_source_rgb:
            x = rgb2ycbcr(x)
        if x.ndim == 2:
            x = x[:, :, None]
        H, W = x.shape[0], x.shape[1]
        ph, pw = (-H) % 8, (-W) % 8
        if ph or pw:  # edge padding: repeat the last row and column
            rows = torch.arange(H + ph, device=self.device).clamp(max=H - 1)
            cols = torch.arange(W + pw, device=self.device).clamp(max=W - 1)
            x = x[rows][:, cols]
        return x.contiguous(), orig_shape

    def _padded_grid(self, original_shape):
        H, W = original_shape[0], original_shape[1]
        C = original_shape[2] if len(original_shape) == 3 else 1
        return -(-H // 8), -(-W // 8), C

    def _symbolize(self, x):
        _, inv_qt = self._tables(x.shape[2])
        return forward_symbolize(x, inv_qt, self.end_of_block)

    # ------------------------------------------------ symbol-level API

    def image2symbols(self, img, is_source_rgb: bool = True) -> np.ndarray:
        """Image -> compact zero-run symbol stream (int32 numpy)."""
        x, _ = self._prepare(img, is_source_rgb)
        buf, valid_len, _ = self._symbolize(x)
        stream, total = compact_symbols(buf, valid_len)
        return stream[: int(total)].cpu().numpy()

    def symbols2image(self, symbols, original_shape) -> torch.Tensor:
        """Symbol stream -> reconstructed image (inverse of image2symbols)."""
        hp, wp, C = self._padded_grid(original_shape)
        qt, _ = self._tables(C)
        s = upload(np.asarray(symbols, dtype=np.int32), self.device)
        blocks, ok = zerorun_decode_stream(s, s.shape[0], hp * wp * C, 64, self.end_of_block)
        if not bool(ok):
            raise ValueError("zero-run decode failed: corrupt stream or wrong shape")
        recon = inverse_reconstruct(blocks, qt, (hp * 8, wp * 8, C))
        return self._finalize(recon, original_shape)

    def _finalize(self, recon_ycbcr, original_shape) -> torch.Tensor:
        H, W = original_shape[0], original_shape[1]
        recon = recon_ycbcr[:H, :W]
        if len(original_shape) == 2:
            return recon[:, :, 0]
        if original_shape[2] == 3:
            return ycbcr2rgb(recon)
        return recon

    # ------------------------------------------------ codebook training

    def _install_code(self, code: CanonicalCode, huffman: HuffmanCoder | None = None):
        """Use ``code`` for encoding and decoding (tables on the device)."""
        if huffman is None:
            huffman = HuffmanCoder(lower_bound=code.lower_bound)
            huffman.code = code
        self.huffman = huffman
        self._enc_codes = upload(code.codes.astype(np.int64), self.device)
        self._enc_lens = upload(code.lengths.astype(np.int64), self.device)
        self._dec_tables = decode_tables(code, self.device)

    def _train_from_buffers(self, buf, valid_len, bounds=None):
        mn, mx = _sym_min_max(buf, valid_len)
        if bounds is None:
            lo, hi = bucket_bounds(int(mn), int(mx))
        else:
            lo, hi = int(bounds[0]), int(bounds[1])
            if not lo <= int(mn) <= int(mx) < hi:
                raise ValueError(f"training symbols [{int(mn)}, {int(mx)}] outside "
                                 f"the bounds [{lo}, {hi})")
        self.bounds = (lo, hi)
        # the pmf is built on the host from the exact integer histogram, so
        # its float32 values (and the tree) are the same on every device
        pmf = pmf_from_histogram(symbol_histogram(buf, valid_len, lo, hi))
        huffman = HuffmanCoder(lower_bound=lo).train(pmf.astype(np.float64))
        self._install_code(huffman.code, huffman)
        return self.huffman

    def train_huffman_from_image(self, training_img, is_source_rgb: bool = True, bounds=None):
        """Symbolize, histogram, and build the canonical codebook.

        The alphabet is the image's symbol range widened and bucketed
        (:func:`bucket_bounds`), or ``bounds`` ``[lo, hi)`` where given,
        which must hold every training symbol."""
        x, _ = self._prepare(training_img, is_source_rgb)
        buf, valid_len, _ = self._symbolize(x)
        self._train_from_buffers(buf, valid_len, bounds)
        return None

    def full_bounds(self, is_source_rgb: bool = True) -> tuple[int, int]:
        """Bucketed bounds ``[lo, hi)`` around every symbol an image of
        levels in [0, 255] can produce under this codec's tables: each
        plane's level range (YCbCr of the RGB cube for RGB sources) through
        each DCT basis function's positive and negative parts, over its
        step, with the EOB and zero-run symbols; widened as training widens
        its range."""
        if is_source_rgb:
            m = _RGB2YCBCR.astype(np.float64)
            lo_px = np.minimum(m, 0).sum(1) * 255 + _YCBCR_OFFSET
            hi_px = np.maximum(m, 0).sum(1) * 255 + _YCBCR_OFFSET
        else:
            lo_px, hi_px = np.zeros(1), np.full(1, 255.0)
        K = dct2_kron_matrix(8)  # scan-ordered rows
        pos, neg = np.maximum(K, 0).sum(1), np.minimum(K, 0).sum(1)
        steps = quant_table_zigzag(self.quantization_scale, lo_px.size).astype(np.float64)
        cmax = (pos[None] * hi_px[:, None] + neg[None] * lo_px[:, None]) / steps
        cmin = (pos[None] * lo_px[:, None] + neg[None] * hi_px[:, None]) / steps
        mn = min(int(np.floor(cmin.min())), 0)
        mx = max(int(np.ceil(cmax.max())), self.end_of_block, 64)
        return bucket_bounds(mn, mx)

    def _require_code(self) -> CanonicalCode:
        if self.huffman is None or self.huffman.code is None:
            raise RuntimeError("Train the Huffman coder before encoding.")
        return self.huffman.code

    # ------------------------------------------------ bitstream API

    def _encode_device(self, x):
        """Encode a prepared plane stack -> stream pieces on the device."""
        code = self._require_code()
        buf, valid_len, qsym = self._symbolize(x)
        num_words = buf.shape[0] * BLOCK_CAP  # worst-case capacity
        words, total_bits, block_offsets = pack_symbols(
            buf, valid_len, self._enc_codes, self._enc_lens, num_words, code.lower_bound)
        return words, total_bits, block_offsets, valid_len, qsym

    @staticmethod
    def _host_words(words, total_bits: int) -> np.ndarray:
        return words[: (total_bits + 31) // 32].cpu().numpy().astype(np.uint32)

    def intra_encode(self, img, return_bpp: bool = False, is_source_rgb: bool = True):
        """Encode to a u32 word stream (numpy); optionally report payload bpp
        with the reference's convention bits/(H*W)."""
        x, orig_shape = self._prepare(img, is_source_rgb)
        words, total_bits, _, valid_len, _ = self._encode_device(x)
        total_bits = int(total_bits)
        self.num_symbols = int(valid_len.sum())
        bitstream = self._host_words(words, total_bits)
        if return_bpp:
            return bitstream, total_bits / (orig_shape[0] * orig_shape[1])
        return bitstream, None

    def intra_decode(self, bitstream, original_shape, num_symbols: int | None = None):
        """Decode a u32 word stream back to an image (serial C++ decode).

        ``num_symbols`` defaults to the encoder side channel, as in the
        reference's API; the container carries it explicitly.
        """
        if num_symbols is None:
            if self.num_symbols is None:
                raise RuntimeError(
                    "No symbol count found. Make sure to encode first or store symbol count."
                )
            num_symbols = self.num_symbols
        symbols = self.huffman.decode(np.asarray(bitstream, dtype=np.uint32), num_symbols)
        return self.symbols2image(symbols.astype(np.int32), original_shape)

    def decode_device(self, words, block_offsets, block_sym_counts, original_shape):
        """Block-parallel decode from per-block bit offsets; returns (recon, ok)."""
        code = self._require_code()
        hp, wp, C = self._padded_grid(original_shape)
        qt, _ = self._tables(C)
        sym_idx = decode_blocks_device(words, block_offsets, block_sym_counts,
                                       self._dec_tables, BLOCK_CAP)
        stream, total = compact_symbols(sym_idx + code.lower_bound, block_sym_counts)
        blocks, ok = zerorun_decode_stream(stream, total, hp * wp * C, 64, self.end_of_block)
        recon = inverse_reconstruct(blocks, qt, (hp * 8, wp * 8, C))
        return self._finalize(recon, original_shape), ok

    # ------------------------------------------------ container API

    def encode_to_container(self, img, is_source_rgb: bool = True) -> bytes:
        """Encode to a self-contained IVC1 byte stream (shape, codebook,
        symbol count and the parallel-decode sidecar all included).

        Runs inside the span ``ivc.intra.encode`` (device time on a card)
        with three children: ``ivc.intra.symbolize`` (colour, transform,
        quantiser, zero-run, block padding), ``ivc.intra.pack`` (the grouped
        pack, the symbol count and group bits read back, the offset rebase)
        and ``ivc.intra.serialize`` (the words, offsets and counts read back
        and the bytes). Each of its five host reads is an ``ivc.fetch``."""
        code = self._require_code()
        with span("ivc.intra.encode", device=self.device):
            with span("ivc.intra.symbolize"):
                x, orig_shape = self._prepare(img, is_source_rgb)
                buf, valid_len, _ = self._symbolize(x)
                buf, valid_len, _ = _pad_blocks(buf, valid_len)
            with span("ivc.intra.pack"):
                group_words, group_bits, block_offsets, _ = pack_symbols_grouped(
                    buf, valid_len, self._enc_codes, self._enc_lens, code.lower_bound)
                self.num_symbols = int(fetch(valid_len.sum()))
                # slice the section to the used words (8-aligned) and rebase the
                # offsets to that stride, so the decoder never materializes the
                # mostly empty full-stride rows
                gb_np = fetch(group_bits).numpy()
                wmax = ct.packer_wmax(gb_np, GROUP_WORDS)
                G = gb_np.shape[0]
                rebase = torch.arange(G, device=self.device).repeat_interleave(PACK_GROUP) * (
                    (GROUP_WORDS - wmax) * 32)
                offsets = block_offsets.to(torch.int64) - rebase
            with span("ivc.intra.serialize"):
                payload = ct.grouped_payload_from_device(
                    kind=ct.KIND_INTRA if len(orig_shape) == 3 else ct.KIND_PLANE,
                    shape=orig_shape,
                    q=self.quantization_scale,
                    eob=self.end_of_block,
                    num_symbols=self.num_symbols,
                    group_words=group_words[:, :wmax],
                    group_bits=gb_np,
                    block_offsets=offsets,
                    block_counts=valid_len,
                    codebook=ct.Codebook(code.lower_bound,
                                         np.asarray(code.lengths, dtype=np.uint8)),
                    words_per_group=wmax,
                    group_size=PACK_GROUP,
                )
                return payload.to_bytes()

    @staticmethod
    def decode_from_container(data: bytes, device: str | torch.device = "cuda",
                              return_device: bool = False):
        """Decode an IVC1 byte stream with a fresh codec on ``device``.

        Returns the reconstruction and raises ``ValueError`` on a corrupt
        stream, which reads the validity flag back to the host.
        ``return_device=True`` returns ``(reconstruction, ok)``, ``ok`` a
        0-d bool tensor on the device, and makes no host synchronisation.

        Runs inside the span ``ivc.intra.decode`` with the video decodes'
        four phases: ``ivc.decode.parse``, ``ivc.decode.tables`` (canonical
        code, decode and quantiser tables), ``ivc.decode.upload`` (the
        section's device views) and ``ivc.decode.enqueue`` (walk, zero-run,
        inverse transform, colour)."""
        with span("ivc.intra.decode"):
            with span("ivc.decode.parse"):
                payload = ct.IntraPayload.from_bytes(data)
            codec = IntraCodec(quantization_scale=payload.quantization_scale,
                               end_of_block=payload.eob, device=device)
            with span("ivc.decode.tables"):
                code = payload.codebook.canonical()
                hp, wp, C = codec._padded_grid(payload.shape)
                qt, _ = codec._tables(C)
                tables = decode_tables(code, codec.device)
            with span("ivc.decode.upload"):
                views = ct.device_views(payload, codec.device)
            with span("ivc.decode.enqueue"):
                recon, ok = decode_grouped_planes(views, tables, code.lower_bound,
                                                  int(payload.block_counts.max(initial=0)),
                                                  (hp, wp, C), payload.eob, qt)
                if not return_device and not bool(fetch(ok)):
                    raise ValueError("container decode failed: corrupt stream")
                recon = codec._finalize(recon, payload.shape)
            return (recon, ok) if return_device else recon

    def encode_decode(self, img, return_bpp: bool = False, is_source_rgb: bool = True,
                      verify_entropy: bool = False):
        """Encode and decode in one device round trip.

        The entropy stage is lossless, so by default the reconstruction
        reuses the quantized coefficients on the device; with
        ``verify_entropy=True`` it runs the full block-parallel Huffman and
        zero-run decode of the packed stream instead.
        """
        x, orig_shape = self._prepare(img, is_source_rgb)
        words, total_bits, block_offsets, valid_len, qsym = self._encode_device(x)
        total_bits = int(total_bits)
        self.num_symbols = int(valid_len.sum())
        bitstream = self._host_words(words, total_bits)

        if verify_entropy:
            recon, ok = self.decode_device(words, block_offsets, valid_len, orig_shape)
            if not bool(ok):
                raise ValueError("entropy round-trip verification failed")
        else:
            hp, wp, C = self._padded_grid(orig_shape)
            qt, _ = self._tables(C)
            recon = self._finalize(inverse_reconstruct(qsym, qt, (hp * 8, wp * 8, C)), orig_shape)

        if return_bpp:
            return recon, bitstream, total_bits, total_bits / (orig_shape[0] * orig_shape[1])
        return recon, bitstream, total_bits


class IntraCodecAdaptive(IntraCodec):
    """Per-image adaptive variant that ships its codebook with the stream,
    as a compact deterministic serialization (lower bound + per-symbol
    canonical code lengths) in place of the reference's pickle."""

    def _serialize_codebook(self) -> bytes:
        code = self._require_code()
        return struct.pack("<iI", code.lower_bound, code.n) + code.lengths.astype(np.uint8).tobytes()

    def _deserialize_codebook(self, blob: bytes):
        lower, n = struct.unpack("<iI", blob[:8])
        lengths = np.frombuffer(blob[8 : 8 + n], dtype=np.uint8).astype(np.int32)
        self._install_code(canonical_from_lengths(lengths, lower))
        self.bounds = (lower, lower + n)

    def intra_encode(self, img, return_bpp: bool = False, is_source_rgb: bool = True):
        x, orig_shape = self._prepare(img, is_source_rgb)
        buf, valid_len, _ = self._symbolize(x)
        self._train_from_buffers(buf, valid_len)
        code = self.huffman.code
        words, total_bits, _ = pack_symbols(buf, valid_len, self._enc_codes, self._enc_lens,
                                            buf.shape[0] * BLOCK_CAP, code.lower_bound)
        total_bits = int(total_bits)
        self.num_symbols = int(valid_len.sum())
        bitstream = self._host_words(words, total_bits)
        blob = self._serialize_codebook()
        packed = (len(blob), blob, bitstream, self.num_symbols)
        if return_bpp:
            return packed, total_bits / (orig_shape[0] * orig_shape[1])
        return packed, total_bits

    def intra_decode(self, packed_bitstream, original_shape, num_symbols: int | None = None):
        _, blob, bitstream, n_syms = packed_bitstream
        self._deserialize_codebook(blob)
        symbols = self.huffman.decode(np.asarray(bitstream, dtype=np.uint32), n_syms)
        return self.symbols2image(symbols.astype(np.int32), original_shape)
