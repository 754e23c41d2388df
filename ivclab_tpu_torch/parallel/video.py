"""GOP × tile sharded video coding with distributed entropy packing.

Port of ``ivclab_tpu/parallel/video.py``:

- the frame stack is split ``(gop, tile)``: independent GOPs across the
  ``gop`` axis (each opens with an I-frame, so the reconstruction
  recursion stays inside a shard), row bands across the ``tile`` axis;
- each shard runs the I/P recursion on its band; before each P-frame the
  reconstructed reference's halo rows come from the neighbouring bands
  (:func:`~ivclab_tpu_torch.parallel.halo.exchange_row_halo`), then the
  band motion search runs locally (the Hopper kernel on CUDA tensors);
- :func:`build_sharded_video_codec` also zero-run codes and Huffman-packs
  every shard's own blocks; the gathered group substreams concatenate
  band-major per frame, which is raster block order, so the streams equal
  ``FusedVideoCodec.pack_gop``'s on the same frames word for word, and
  :func:`assemble_video_payloads` turns them into IVC1 bytes;
- :class:`ShardedAdaptiveEncoder` does the same with per-frame codebooks,
  and its bytes are ``VideoCodec.encode_to_container``'s.

The JAX ``shard_map`` becomes a loop over the shards this process holds
(all of them in-process, one per rank in distributed mode); ``psum`` over
``tile`` becomes an in-process sum or an ``all_reduce`` over the GOP's tile
group, and the ``out_specs`` gather a concatenation or an ``all_gather``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ivclab_tpu_torch.models.fastvideo import EOB, PackedGop, _map_gop_hot, _symbolize
from ivclab_tpu_torch.models.videocodec import (
    _adaptive_payload,
    _code_tables,
    _in_group,
    _sized_buckets_ok,
    _stream_histogram,
    _to_host,
    _train_codes,
    _uniform_mv_code,
)
from ivclab_tpu_torch.ops import transform as tf
from ivclab_tpu_torch.ops.dct import require_full_fp32
from ivclab_tpu_torch.ops.motion import BLOCK
from ivclab_tpu_torch.ops.quant import quant_table_zigzag
from ivclab_tpu_torch.ops.transform import (
    GROUP_WORDS,
    PACK_GROUP,
    cap_slice,
    pack_grouped_sized,
    pack_symbols_grouped,
    symbol_histogram,
)
from ivclab_tpu_torch.ops.zerorun import BLOCK_CAP, zerorun_encode_blocks
from ivclab_tpu_torch.parallel.halo import (
    exchange_row_halo,
    motion_compensate_tile,
    motion_search_tile,
)
from ivclab_tpu_torch.parallel.mesh import Mesh
from ivclab_tpu_torch.runtime.container import GroupedSection, packer_wmax
from ivclab_tpu_torch.utils.shape import upload


def shard_frames(frames_y, mesh: Mesh) -> dict:
    """Cut a ``[T, H, W]`` stack into this process's shards.

    T splits over ``gop`` (gop-major) and H over ``tile``. Returns
    ``{(g, i): [T / n_gop, H / n_tile, W] float32}`` on the mesh's device:
    every shard in-process, this rank's one in distributed mode.
    """
    if isinstance(frames_y, torch.Tensor):
        x = frames_y.to(device=mesh.device, dtype=torch.float32)
    else:
        x = upload(np.asarray(frames_y, dtype=np.float32), mesh.device)
    T, H, W = x.shape
    if T % mesh.n_gop or H % mesh.n_tile:
        raise ValueError(f"[{T}, {H}, {W}] frames do not split over a "
                         f"{mesh.n_gop}x{mesh.n_tile} mesh")
    gl, bh = T // mesh.n_gop, H // mesh.n_tile
    return {(g, i): x[g * gl:(g + 1) * gl, i * bh:(i + 1) * bh].contiguous()
            for g, i in mesh.local_shards()}


def _check_shards(shards: dict, mesh: Mesh, gop_len: int, band_h: int, width: int):
    if sorted(shards) != sorted(mesh.local_shards()):
        raise ValueError(f"shards {sorted(shards)} are not this process's "
                         f"{mesh.local_shards()}")
    for key, x in shards.items():
        if tuple(x.shape) != (gop_len, band_h, width):
            raise ValueError(f"shard {key} is {tuple(x.shape)}, "
                             f"expected {(gop_len, band_h, width)}")


def _band_recursion(shards: dict, mesh: Mesh, total_h: int, sr: int, qt, inv_qt) -> dict:
    """The I/P recursion of every local shard, frame by frame in lockstep
    across the tiles of each GOP (the halo exchange needs the neighbours'
    previous reconstructions).

    Motion search and compensation run per band. The transform runs once
    per frame over the concatenated local bands, which in-process is the
    whole frame: the same ``[N, 64]`` product the fused codec computes, so
    a GEMM that picks its kernel by row count cannot round the bands
    differently from the whole frame.

    Returns ``{(g, i): (qsyms [T, Nb, 64], mvs [T, hb, wb], recons [T, Ht, W])}``.
    """
    out = {}
    for g in sorted({g for g, _ in shards}):
        tiles = sorted(i for gg, i in shards if gg == g)
        frames = [shards[(g, i)] for i in tiles]
        gop_len, band_h, W = frames[0].shape
        n = len(tiles)
        center = torch.full((band_h // BLOCK, W // BLOCK), sr * (2 * sr + 1) + sr,
                            dtype=torch.int32, device=frames[0].device)
        qsyms, mvs, recons = [], [], []
        recon = None
        for t in range(gop_len):
            if t == 0:
                mv = [center] * n
                planes = [f[0] for f in frames]
            else:
                exts = exchange_row_halo(recon, sr, mesh)
                mv = [motion_search_tile(exts[k], frames[k][t], i * band_h, total_h, sr)
                      for k, i in enumerate(tiles)]
                pred = [motion_compensate_tile(exts[k], mv[k], sr) for k in range(n)]
                planes = [frames[k][t] - pred[k] for k in range(n)]
            qsym, rrec = _symbolize(torch.cat(planes), qt, inv_qt)
            rrec = rrec.split(band_h)
            recon = list(rrec) if t == 0 else [pred[k] + rrec[k] for k in range(n)]
            qsyms.append(qsym.reshape(n, -1, 64))
            mvs.append(torch.stack(mv))
            recons.append(torch.stack(recon))
        qsyms, mvs, recons = (torch.stack(x, dim=1) for x in (qsyms, mvs, recons))
        for k, i in enumerate(tiles):
            out[(g, i)] = (qsyms[k], mvs[k], recons[k])
    return out


_REDUCE = {
    "sum": (lambda x, dim: x.sum(dim=dim, dtype=x.dtype), dist.ReduceOp.SUM),
    "min": (torch.amin, dist.ReduceOp.MIN),
    "max": (torch.amax, dist.ReduceOp.MAX),
}


def _tile_psum(mesh: Mesh, local: dict, op: str = "sum") -> dict:
    """Reduce each GOP's per-tile values over its tiles (``op``: sum, min or
    max); every shard of the GOP gets the result (JAX ``psum``, ``pmin``,
    ``pmax`` over ``tile``)."""
    fn, dist_op = _REDUCE[op]
    if not mesh.distributed:
        out = {g: fn(torch.stack([v for (gg, _), v in local.items() if gg == g]), dim=0)
               for g, _ in local}
        return {(g, i): out[g] for g, i in local}
    ((g, i), v), = local.items()
    v = v.clone()
    dist.all_reduce(v, op=dist_op, group=mesh.tile_groups[g])
    return {(g, i): v}


def _gop_gather(mesh: Mesh, local: dict) -> dict:
    """``{g: [tensor of tile 0, ..., tile n_tile - 1]}`` for each GOP this
    process holds (an ``all_gather`` over the GOP's tile group in
    distributed mode, where the tiles' tensors have one shape)."""
    if not mesh.distributed:
        return {g: [local[(g, i)] for i in range(mesh.n_tile)] for g in sorted({g for g, _ in local})}
    ((g, _), v), = local.items()
    v = v.contiguous()
    parts = [torch.empty_like(v) for _ in range(mesh.n_tile)]
    dist.all_gather(parts, v, group=mesh.tile_groups[g])
    return {g: parts}


def _all_shards(mesh: Mesh, local: dict) -> dict:
    """``{(g, i): tensor}`` for every shard of the mesh (all-gather in
    distributed mode; every shard's tensor has the same shape)."""
    if not mesh.distributed:
        return local
    (_, v), = local.items()
    v = v.contiguous()
    parts = [torch.empty_like(v) for _ in range(mesh.n_gop * mesh.n_tile)]
    dist.all_gather(parts, v)
    return {divmod(r, mesh.n_tile): p for r, p in enumerate(parts)}


def _band_major(mesh: Mesh, shards: dict) -> torch.Tensor:
    """Global ``[n_gop * gop_len, n_tile * band, ...]`` from per-shard
    ``[gop_len, band, ...]``: gop-major on axis 0, band-major on axis 1."""
    return torch.cat([torch.cat([shards[(g, i)] for i in range(mesh.n_tile)], dim=1)
                      for g in range(mesh.n_gop)])


def _per_gop(mesh: Mesh, shards: dict) -> torch.Tensor:
    """Global ``[n_gop * gop_len, ...]`` from tile-replicated per-shard values."""
    return torch.cat([shards[(g, 0)] for g in range(mesh.n_gop)])


def build_sharded_video_encoder(mesh: Mesh, gop_len: int, band_h: int, width: int,
                                quantization_scale: float = 1.0, search_range: int = 4,
                                residual_code=None, mv_code=None):
    """A GOP+tile-sharded encode step that reports the rate without packing.

    Returns ``step(shards) -> (recons [T, H, W], bits [T])`` over the
    output of :func:`shard_frames` for ``[n_gop * gop_len, band_h * n_tile,
    width]`` frames. The codebooks are fixed (``residual_code`` and
    ``mv_code`` give ``.lengths`` over the alphabet and the residual code's
    ``.lower_bound``); without them the rate uses the JAX package's proxy,
    6 bits per residual symbol and 7 per motion index.
    """
    dev = mesh.device
    H = band_h * mesh.n_tile
    sr = search_range
    qt_np = quant_table_zigzag(quantization_scale, 1)[0]
    qt = upload(qt_np, dev)
    inv_qt = upload((1.0 / qt_np).astype(np.float32), dev)
    if residual_code is not None:
        enc_lens = upload(np.asarray(residual_code.lengths, np.int32), dev)
        lower = int(residual_code.lower_bound)
    else:
        enc_lens = torch.full((5120,), 6, dtype=torch.int32, device=dev)
        lower = -1024
    n_mv = (2 * sr + 1) ** 2
    if mv_code is not None:
        mv_lens = upload(np.asarray(mv_code.lengths, np.int32), dev)
    else:
        mv_lens = torch.full((n_mv,), 7, dtype=torch.int32, device=dev)

    def step(shards: dict):
        _check_shards(shards, mesh, gop_len, band_h, width)
        enc = _band_recursion(shards, mesh, H, sr, qt, inv_qt)
        bits, recons = {}, {}
        for key, (qsyms, mvs, rec) in enc.items():
            buf, valid = zerorun_encode_blocks(qsyms.reshape(-1, 64), 64, EOB, BLOCK_CAP)
            mask = torch.arange(BLOCK_CAP, device=dev)[None, :] < valid[:, None]
            idx = (buf - lower).clamp(0, enc_lens.shape[0] - 1).long()
            rbits = torch.where(mask, enc_lens[idx], 0).reshape(gop_len, -1).sum(
                dim=1, dtype=torch.int32)
            mvb = mv_lens[mvs.clamp(0, mv_lens.shape[0] - 1).long()].reshape(gop_len, -1).sum(
                dim=1, dtype=torch.int32)
            mvb[0] = 0  # the I-frame codes no motion
            bits[key] = rbits + mvb
            recons[key] = rec
        bits = _tile_psum(mesh, bits)
        return (_band_major(mesh, _all_shards(mesh, recons)),
                _per_gop(mesh, _all_shards(mesh, bits)))

    return step


class ShardedGopStreams(NamedTuple):
    """Gathered outputs of one sharded encode+pack step.

    Frames are gop-major on the T axis; within a frame, blocks and groups
    are band-major, which is raster order, so every field equals the
    single-device ``FusedVideoCodec`` output on the same frames.
    """

    words: torch.Tensor       # [T, G, GW] int64 32-bit group substream words
    offsets: torch.Tensor     # [T, N] frame-relative block bit offsets
    counts: torch.Tensor      # [T, N] per-block symbol counts
    group_bits: torch.Tensor  # [T, G] exact per-group payload bits
    totals: torch.Tensor      # [T] per-frame residual bits (summed over tiles)
    mvs: torch.Tensor         # [T, H/8, W/8] packed motion indices
    recons: torch.Tensor      # [T, H, W] closed-loop reconstructions


def build_sharded_video_codec(mesh: Mesh, codec, gop_len: int, band_h: int, width: int,
                              cap: int, group_words: int, block_words: int):
    """A GOP+tile-sharded encode **and entropy-pack** step.

    Each (gop, tile) shard runs the I/P recursion on its band with halo
    motion search, then zero-run codes and hot/escape Huffman-packs its own
    blocks into word-aligned group substreams and rebases its block bit
    offsets by its tile's group prefix (``tile * Gb * GW * 32``), so the
    gathered offsets index the global frame stream.

    ``codec`` is a trained :class:`~ivclab_tpu_torch.models.fastvideo.FusedVideoCodec`;
    ``cap``/``group_words``/``block_words`` are the pack's size buckets and
    must be the fused codec's (``codec._buckets`` after a ``pack_gop``) for
    identical streams. Returns ``step(shards) -> ShardedGopStreams`` over
    the output of :func:`shard_frames` for ``[n_gop * gop_len, band_h *
    n_tile, width]`` frames.
    """
    dev = mesh.device
    H, W = band_h * mesh.n_tile, width
    Nb = (band_h // BLOCK) * (W // BLOCK)
    if band_h % BLOCK or W % BLOCK or Nb % PACK_GROUP:
        raise ValueError(f"band {band_h}x{W}: blocks ({Nb}) must be a multiple of "
                         f"PACK_GROUP ({PACK_GROUP})")
    Gb = Nb // PACK_GROUP
    sr = codec.sr
    code = codec.residual_code
    qt, inv_qt = codec.qt.to(dev), codec.inv_qt.to(dev)
    hv, hf, esc_code, esc_len = codec._enc
    hv, hf = hv.to(dev), hf.to(dev)
    group_span = Gb * group_words * 32  # bits of one band's groups in a frame
    # shard-local group index (t*Gb + g) -> frame-relative global group
    # index (tile*Gb + g): subtract each frame's local base, add the tile's
    local_base = torch.arange(gop_len, dtype=torch.int32, device=dev)[:, None] * group_span

    def step(shards: dict) -> ShardedGopStreams:
        _check_shards(shards, mesh, gop_len, band_h, width)
        enc = _band_recursion(shards, mesh, H, sr, qt, inv_qt)
        fields = {name: {} for name in ShardedGopStreams._fields if name != "totals"}
        frame_bits = {}
        for (g, i), (qsyms, mvs, recons) in enc.items():
            codes, lens, valid, *_ = _map_gop_hot(qsyms, hv, hf, esc_code, esc_len,
                                                  code.lower_bound, cap, code.raw_bits)
            words, gbits, offs = pack_grouped_sized(codes, lens, group_words, block_words)
            gbits = gbits.reshape(gop_len, Gb)
            shard = {
                "words": words.reshape(gop_len, Gb, group_words),
                "offsets": offs.reshape(gop_len, Nb) - local_base + i * group_span,
                "counts": valid.reshape(gop_len, Nb),
                "group_bits": gbits,
                "mvs": mvs,
                "recons": recons,
            }
            for name, v in shard.items():
                fields[name][(g, i)] = v
            frame_bits[(g, i)] = gbits.sum(dim=1, dtype=torch.int32)
        out = {name: _band_major(mesh, _all_shards(mesh, v)) for name, v in fields.items()}
        out["totals"] = _per_gop(mesh, _all_shards(mesh, _tile_psum(mesh, frame_bits)))
        return ShardedGopStreams(**out)

    return step


def assemble_video_payloads(codec, streams: ShardedGopStreams, gop_len: int) -> list:
    """Bitstream assembly: gathered shard streams -> one IVC1 payload per GOP.

    Each GOP's slice of the streams goes through the same
    ``container_from_packed`` writer as the single-device encoder, so the
    bytes are the ones ``FusedVideoCodec`` writes for those frames and
    decode anywhere via ``FusedVideoCodec.decode_from_container``.
    """
    T, H, W = streams.recons.shape
    payloads = []
    for g in range(T // gop_len):
        sl = slice(g * gop_len, (g + 1) * gop_len)
        counts = streams.counts[sl]
        p = PackedGop(
            words=streams.words[sl],
            totals=streams.totals[sl],
            offsets=streams.offsets[sl],
            counts=counts,
            group_bits=streams.group_bits[sl],
            block_words=None,  # the decoder recovers it from the sidecar
            cap=max(int(counts.max()), 1),
            ok=torch.ones((), dtype=torch.bool),
        )
        payloads.append(codec.container_from_packed(p, streams.mvs[sl], (gop_len, H, W)))
    return payloads


class ShardedAdaptiveEncoder:
    """GOP × tile sharded encoder with per-frame residual codebooks.

    ``encode`` returns one ``AdaptiveVideoPayload`` per GOP, byte for byte
    what the single-device ``VideoCodec.encode_to_container`` writes for that
    GOP's frames:

    - phase 1: every shard's I/P recursion with the halo exchange and the
      band motion search (the kernel's band entry point on the card), the
      transform once per frame over the local bands
      (:func:`_band_recursion`), zero-run symbols and per-tile statistics,
      reduced over the GOP's tiles (histograms summed, bounds and counts
      min/max);
    - on the host, each frame's canonical code from those statistics;
    - phase 2: every shard packs its own blocks under the frame's code into
      the speculative ``ADAPTIVE_WPG``/``ADAPTIVE_BW`` buckets; the gathered
      sidecar decides frame by frame which frames re-pack full-stride (their
      count in the last ``encode`` is ``full_stride_frames``); each frame's
      used words are gathered and its section assembled from its global
      offsets.

    The JAX constructor's ``me_backend`` (Pallas or XLA on the TPU) has no
    counterpart here: the band search dispatches on the tensors' device.
    """

    def __init__(self, mesh: Mesh, gop_len: int, band_h: int, width: int,
                 quantization_scale: float = 1.0, search_range: int = 4,
                 codebook_policy: str = "per-frame", eob: int = 4000):
        if codebook_policy not in ("per-frame", "adaptive"):
            raise ValueError("sharded adaptive encoder: policy must be 'per-frame' or 'adaptive'")
        if band_h % BLOCK or width % BLOCK:
            raise ValueError("band_h and width must be multiples of 8")
        self.Nb = (band_h // BLOCK) * (width // BLOCK)
        if self.Nb % PACK_GROUP:
            raise ValueError(f"band blocks ({self.Nb}) must be a multiple of PACK_GROUP "
                             f"({PACK_GROUP}) for byte-identity with the single-device pack")
        self.mesh = mesh
        self.gop_len = int(gop_len)
        self.band_h = int(band_h)
        self.width = int(width)
        self.H = self.band_h * mesh.n_tile
        self.q = float(quantization_scale)
        self.sr = int(search_range)
        self.eob = int(eob)
        self.policy = codebook_policy
        qt = quant_table_zigzag(self.q, 1)[0]
        self.qt = upload(qt, mesh.device)
        self.inv_qt = upload((1.0 / qt).astype(np.float32), mesh.device)
        self.mv_code = _uniform_mv_code(self.sr).code
        self.full_stride_frames = 0

    def _phase1(self, shards: dict):
        """Symbols, motion fields and tile-reduced statistics of every local shard."""
        mesh, L, Nb = self.mesh, self.gop_len, self.Nb
        enc = _band_recursion(shards, mesh, self.H, self.sr, self.qt, self.inv_qt)
        bufs, valids, mvs = {}, {}, {}
        stats = {"mn": {}, "mx": {}, "hist": {}, "vmax": {}}
        for key, (qsyms, mv, _) in enc.items():
            buf, valid = zerorun_encode_blocks(qsyms.reshape(-1, 64), 64, self.eob, BLOCK_CAP)
            bufs[key], valids[key], mvs[key] = buf.reshape(L, Nb, -1), valid.reshape(L, Nb), mv
            per_frame = [_stream_histogram(bufs[key][t], valids[key][t]) for t in range(L)]
            for j, name in enumerate(("mn", "mx", "hist")):
                stats[name][key] = torch.stack([s[j] for s in per_frame])
            stats["vmax"][key] = valids[key].amax(dim=1)
        ops = {"mn": "min", "mx": "max", "hist": "sum", "vmax": "max"}
        stats = {name: _tile_psum(mesh, v, ops[name]) for name, v in stats.items()}
        return bufs, valids, mvs, stats

    def _train(self, g: int, bufs: dict, valids: dict, stats: dict):
        """The per-frame codes of GOP ``g`` and its frames' largest counts."""
        keys = [k for k in bufs if k[0] == g]
        mn_np, mx_np, hist_np, vmax_np = _to_host(
            [stats[name][keys[0]] for name in ("mn", "mx", "hist", "vmax")])

        def direct(t, lo, hi):  # bounds outside the full-range window
            local = {k: symbol_histogram(bufs[k][t], valids[k][t], lo, hi) for k in keys}
            return _tile_psum(self.mesh, local)[keys[0]]

        return _train_codes(mn_np, mx_np, hist_np, direct), vmax_np

    def encode(self, frames_y) -> list:
        """``[n_gop * gop_len, H, W]`` float32 luma -> one adaptive container
        (``bytes``) per GOP; in distributed mode every rank returns all of them."""
        mesh, L, Gb = self.mesh, self.gop_len, self.Nb // PACK_GROUP
        shards = shard_frames(frames_y, mesh)
        _check_shards(shards, mesh, L, self.band_h, self.width)
        if mesh.device.type == "cuda":
            require_full_fp32()
        bufs, valids, mvs, stats = self._phase1(shards)
        gops = sorted({g for g, _ in bufs})
        trained = {g: self._train(g, bufs, valids, stats) for g in gops}

        wpg, bw = tf.ADAPTIVE_WPG, tf.ADAPTIVE_BW
        tables = {g: _code_tables(trained[g][0], mesh.device) for g in gops}
        packs = {}  # (g, i) -> per frame [words, group bits, offsets]
        for (g, i) in bufs:
            codes, vmax_np = trained[g]
            packs[(g, i)] = [list(tf.pack_symbols_grouped_sized(
                bufs[(g, i)][t][:, :cap_slice(int(vmax_np[t]), BLOCK_CAP)], valids[(g, i)][t],
                *tables[g][t], codes[t].lower_bound, wpg, bw)[:3]) for t in range(L)]
        strides = {g: [wpg] * L for g in gops}

        def sidecar():
            """Gathered (group bits [L, G], frame-global offsets [L, N]) per GOP."""
            local = {}
            for (g, i), per_frame in packs.items():
                s = upload(np.asarray(strides[g], dtype=np.int64), mesh.device)[:, None] * 32
                offs = torch.stack([f[2].to(torch.int64) for f in per_frame]) + i * Gb * s
                local[(g, i)] = torch.cat([torch.stack([f[1].to(torch.int64) for f in per_frame]),
                                           offs], dim=1)
            out = {}
            for g, parts in _gop_gather(mesh, local).items():
                gb = torch.cat([p[:, :Gb] for p in parts], dim=1)
                out[g] = (gb, torch.cat([p[:, Gb:] for p in parts], dim=1))
            return out

        side = {g: _to_host(v) for g, v in sidecar().items()}
        self.full_stride_frames = 0
        for g in gops:
            codes, _ = trained[g]
            gb_np, offs_np = side[g]
            for t in range(L):
                if _sized_buckets_ok(gb_np[t], _in_group(offs_np[t], wpg), wpg, bw):
                    continue
                self.full_stride_frames += 1
                strides[g][t] = GROUP_WORDS
                for key in packs:
                    if key[0] == g:
                        packs[key][t] = list(pack_symbols_grouped(
                            bufs[key][t], valids[key][t], *tables[g][t], codes[t].lower_bound)[:3])
        if self.full_stride_frames:
            side = {g: _to_host(v) for g, v in sidecar().items()}

        wmax = {g: [packer_wmax(side[g][0][t], strides[g][t]) for t in range(L)] for g in gops}
        local_words = {}
        for key, per_frame in packs.items():
            local_words[key] = torch.cat([f[0][:, :wmax[key[0]][t]].reshape(-1)
                                          for t, f in enumerate(per_frame)])
        gathered = _gop_gather(mesh, local_words)
        counts = _gop_gather(mesh, valids)
        motion = _gop_gather(mesh, mvs)
        payloads = {}
        for g in gops:
            host = _to_host(gathered[g] + [torch.cat(counts[g], dim=1),
                                           torch.cat(motion[g], dim=1)])
            shard_words, (counts_np, mvs_np) = host[:-2], host[-2:]
            gb_np, offs_np = side[g]
            codes, _ = trained[g]
            packed, off = [], 0
            for t in range(L):
                w = wmax[g][t]
                frame_words = np.concatenate(
                    [sw[off:off + Gb * w].reshape(Gb, w) for sw in shard_words])
                off += Gb * w
                section = GroupedSection.from_packer_sliced(
                    frame_words, gb_np[t], offs_np[t], counts_np[t], PACK_GROUP,
                    strides[g][t], w)
                packed.append((section, int(gb_np[t].sum())))
            payloads[g] = _adaptive_payload(self.q, self.eob, self.sr, self.policy,
                                            (L, self.H, self.width), codes, packed, mvs_np,
                                            self.mv_code)
        if mesh.distributed:
            everyone = [None] * dist.get_world_size()
            dist.all_gather_object(everyone, payloads)
            payloads = {g: p for d in everyone for g, p in d.items()}
        return [payloads[g] for g in range(mesh.n_gop)]
