"""Command-line interface of the PyTorch port.

Port of ``ivclab_tpu/cli.py``: the same subcommands, flags, defaults, JSON
reports and ``.ivc`` files (IVC1 containers; IVCS video streams), byte for
byte:

  python -m ivclab_tpu_torch.cli encode-image  fixture:lena out.ivc --q 0.15
  python -m ivclab_tpu_torch.cli decode-image  out.ivc recon.png
  python -m ivclab_tpu_torch.cli roundtrip-image fixture:lena --q 0.15
  python -m ivclab_tpu_torch.cli rd-sweep --kind image|video|dpcm|image-vs-video
  python -m ivclab_tpu_torch.cli encode-video  fixture:foreman out.ivc --q 1.0 --frames 8
  python -m ivclab_tpu_torch.cli decode-video  out.ivc frames.npy
  python -m ivclab_tpu_torch.cli info out.ivc

Images may be files (anything PIL reads) or ``fixture:<name>`` synthetic
fixtures; video sources are ``fixture:<name>`` or a directory of frames.
The port's one addition is ``--device`` (before the subcommand; default
``cuda``): every codec runs there, and without a card the default raises
rather than running on the CPU. ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
from pathlib import Path

import numpy as np
import torch


def _load_image(spec: str) -> np.ndarray:
    if spec.startswith("fixture:"):
        from ivclab_tpu_torch.utils import fixtures

        return fixtures.image(spec.split(":", 1)[1])
    from ivclab_tpu_torch.utils.io import imread

    return imread(spec)


def _load_video(spec: str, frames: int) -> np.ndarray:
    if spec.startswith("fixture:"):
        from ivclab_tpu_torch.utils import fixtures

        return fixtures.video(spec.split(":", 1)[1], num_frames=frames)
    from ivclab_tpu_torch.utils.io import imread

    paths = sorted(Path(spec).glob("*"))[:frames]
    return np.stack([imread(str(p)) for p in paths])


def _psnr(orig, rec) -> float:
    from ivclab_tpu_torch.utils import calc_psnr

    return float(calc_psnr(orig, rec))


def cmd_encode_image(args):
    from ivclab_tpu_torch.models import IntraCodec

    img = _load_image(args.input)
    train = _load_image(args.train) if args.train else img
    codec = IntraCodec(quantization_scale=args.q, device=args.device)
    codec.train_huffman_from_image(train)
    blob = codec.encode_to_container(img)
    Path(args.output).write_bytes(blob)
    H, W = img.shape[:2]
    print(
        json.dumps(
            {
                "container_bytes": len(blob),
                "payload_bpp": round(_payload_bits(blob) / (H * W), 4),
            }
        )
    )


def _payload_bits(blob: bytes) -> int:
    from ivclab_tpu_torch.runtime.container import IntraPayload

    return IntraPayload.from_bytes(blob).payload_bits


def cmd_decode_image(args):
    from ivclab_tpu_torch.models import IntraCodec
    from ivclab_tpu_torch.utils.io import imwrite

    recon = IntraCodec.decode_from_container(Path(args.input).read_bytes(), device=args.device)
    imwrite(args.output, recon)
    print(json.dumps({"shape": list(recon.shape)}))


def cmd_roundtrip_image(args):
    from ivclab_tpu_torch.models import IntraCodec

    img = _load_image(args.input)
    train = _load_image(args.train) if args.train else img
    codec = IntraCodec(quantization_scale=args.q, device=args.device)
    codec.train_huffman_from_image(train)
    recon, _, _, bpp = codec.encode_decode(img, return_bpp=True)
    print(json.dumps({"psnr_db": round(_psnr(img, recon), 3), "bpp": round(bpp, 4)}))


STREAM_MAGIC = b"IVCS"


def write_video_stream(path, gop_blobs):
    """Write a sequence of GOP payloads with length framing."""
    with open(path, "wb") as f:
        f.write(STREAM_MAGIC + struct.pack("<HI", 1, len(gop_blobs)))
        for blob in gop_blobs:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)


def read_video_stream(path):
    """Parse an IVCS stream file; truncated/hostile framing raises a clean
    ValueError (the per-GOP payloads get their own bounds-checked parse)."""
    data = Path(path).read_bytes()
    if data[:4] != STREAM_MAGIC:
        raise ValueError("not an IVCS video stream")
    head = 4 + struct.calcsize("<HI")
    if len(data) < head:
        raise ValueError("truncated IVCS stream header")
    _, n = struct.unpack_from("<HI", data, 4)
    off = head
    blobs = []
    for _ in range(n):
        if off + 8 > len(data):
            raise ValueError("truncated IVCS stream (GOP length)")
        (ln,) = struct.unpack_from("<Q", data, off)
        off += 8
        if off + ln > len(data):
            raise ValueError("truncated IVCS stream (GOP payload)")
        blobs.append(bytes(data[off : off + ln]))
        off += ln
    return blobs


def _blob_kind(blob: bytes) -> int:
    """Kind byte of an IVC1 blob; clean error on short/foreign bytes."""
    if len(blob) < 7 or blob[:4] != b"IVC1":
        raise ValueError("not an IVC1 container")
    return blob[6]


def _make_timer(args):
    from ivclab_tpu_torch.runtime.trace import StageTimer

    return StageTimer(enabled=bool(getattr(args, "trace", False)), annotate=False)


def _add_trace(out: dict, timer, pixels: int) -> None:
    """With ``--trace``: per-stage ms + Mpix/s under ``trace``, and the
    port's spans (host ms and calls a name) and counters under ``spans``."""
    if not timer.enabled or not timer.totals:
        return
    rep = timer.report()
    for name, row in rep.items():
        if row["total_s"] > 0:
            row["mpix_per_s"] = round(pixels / row["total_s"] / 1e6, 2)
    out["trace"] = rep
    from ivclab_tpu_torch.runtime import trace

    out["spans"] = trace.summary()


def cmd_encode_video(args):
    """Encode to a real .ivc bitstream file (the Y plane: the reference's
    video codec is luma-only too) and report RD stats. ``--codebook-policy
    first-p-frame`` uses the fused fixed-codebook GOP codec;
    ``per-frame``/``adaptive`` serialize per-frame codebooks through the
    adaptive container. Every stage runs on ``--device``; a stage's time
    ends when that device has finished its work."""
    from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec
    from ivclab_tpu_torch.ops.color import rgb2ycbcr

    dev = torch.device(args.device)
    timer = _make_timer(args)
    frames = _load_video(args.input, args.frames)
    y = rgb2ycbcr(torch.from_numpy(frames).to(dev))[..., 0].contiguous()
    gop = args.gop or frames.shape[0]
    blobs, recons, bits = [], [], []
    if args.mesh_gop or args.mesh_tile:
        blobs, recons, bits = _encode_video_sharded(args, y, gop, timer)
    elif args.codebook_policy in ("per-frame", "adaptive"):
        from ivclab_tpu_torch.models.videocodec import VideoCodec
        from ivclab_tpu_torch.runtime.container import AdaptiveVideoPayload

        codec = VideoCodec(
            quantization_scale=args.q,
            search_range=args.search_range,
            codebook_policy=args.codebook_policy,
            device=dev,
        )
        for start in range(0, y.shape[0], gop):
            chunk = y[start : start + gop]
            with timer.stage("encode", sync=chunk):
                blob = codec.encode_to_container(chunk)
            blobs.append(blob)
            with timer.stage("decode-check", sync=chunk):
                r = VideoCodec.decode_from_container(blob, device=dev)
            recons.append(r)
            bits.extend(int(b) for b in AdaptiveVideoPayload.from_bytes(blob).frame_bits)
    else:
        # pad the frame count to whole GOPs (each opens with an I-frame)
        codec = FusedVideoCodec(quantization_scale=args.q, search_range=args.search_range,
                                device=dev)
        with timer.stage("train", sync=y):
            codec.train(y[: min(2, y.shape[0])])
        for start in range(0, y.shape[0], gop):
            chunk = y[start : start + gop]
            with timer.stage("encode", sync=chunk):
                qsyms, mvs, mv_bits, _ = codec.encode_gop(chunk)
            with timer.stage("pack", sync=chunk):
                p = codec.pack_gop(qsyms)
            with timer.stage("serialize"):
                blobs.append(codec.container_from_packed(p, mvs, tuple(chunk.shape)))
            with timer.stage("decode-check", sync=chunk):
                r, ok = codec.decode_gop(
                    p.words, p.offsets, p.counts, mvs,
                    chunk.shape[1], chunk.shape[2], p.block_words, p.cap,
                )
            assert bool(ok), "entropy decode self-check failed"
            recons.append(r.cpu().numpy())
            bits.extend(int(x) for x in (p.totals + mv_bits).cpu().numpy())
    write_video_stream(args.output, blobs)
    y_host = y.cpu().numpy()
    recon_y = np.concatenate(recons)
    psnrs = [_psnr(y_host[t], recon_y[t]) for t in range(y_host.shape[0])]
    out = {
        "output": args.output,
        "container_bytes": sum(len(b) for b in blobs),
        "frames": int(y_host.shape[0]),
        "gops": len(blobs),
        "mean_psnr_y_db": round(float(np.mean(psnrs)), 3),
        "mean_bpp": round(float(np.mean(bits)) / (y_host.shape[1] * y_host.shape[2]), 4),
        "per_frame_bits": bits,
    }
    _add_trace(out, timer, int(y_host.size))
    print(json.dumps(out))


def _mesh_shape(args, dev: torch.device) -> tuple[int, int]:
    """``--mesh-gop`` x ``--mesh-tile``. Where one is missing it is factored
    as the JAX package's ``make_mesh`` does, over the devices of the kind
    ``dev`` names (the CUDA card count; 1 for the CPU)."""
    from ivclab_tpu_torch.parallel.mesh import _factor

    if args.mesh_gop and args.mesh_tile:
        return args.mesh_gop, args.mesh_tile
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return _factor(n, args.mesh_gop, args.mesh_tile)


def _encode_video_sharded(args, y, gop: int, timer):
    """Encode through the (gop, tile)-sharded paths on an in-process mesh on
    ``--device``.

    ``--mesh-gop``/``--mesh-tile`` pick the mesh's shape
    (``config.MeshConfig``); ``first-p-frame`` streams through the fused
    sharded codec (per-shard entropy pack + assembly), ``per-frame``/
    ``adaptive`` through the sharded adaptive encoder. All produce the same
    self-contained IVC1 blobs as the single-device encoders, byte for byte.
    """
    from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec
    from ivclab_tpu_torch.parallel.mesh import make_mesh
    from ivclab_tpu_torch.runtime.container import AdaptiveVideoPayload, VideoPayload

    dev = y.device
    mesh = make_mesh(*_mesh_shape(args, dev), device=dev)
    n_gop, n_tile = mesh.shape["gop"], mesh.shape["tile"]
    T, H, W = y.shape
    if H % n_tile or (H // n_tile) % 8:
        raise SystemExit(
            f"frame height {H} does not split into {n_tile} 8-aligned bands"
        )
    if T % (n_gop * gop):
        raise SystemExit(
            f"{T} frames do not fill {n_gop} device GOPs of {gop} frames"
        )
    band_h = H // n_tile
    blobs, recons, bits = [], [], []
    if args.codebook_policy in ("per-frame", "adaptive"):
        from ivclab_tpu_torch.models.videocodec import VideoCodec
        from ivclab_tpu_torch.parallel.video import ShardedAdaptiveEncoder

        enc = ShardedAdaptiveEncoder(
            mesh, gop, band_h, W, quantization_scale=args.q,
            search_range=args.search_range, codebook_policy=args.codebook_policy,
        )
        for start in range(0, T, n_gop * gop):
            with timer.stage("encode", sync=y):
                blobs.extend(enc.encode(y[start : start + n_gop * gop]))
        for blob in blobs:
            with timer.stage("decode-check", sync=y):
                recons.append(VideoCodec.decode_from_container(blob, device=dev))
            bits.extend(int(b) for b in AdaptiveVideoPayload.from_bytes(blob).frame_bits)
        return blobs, recons, bits

    from ivclab_tpu_torch.parallel.video import (
        assemble_video_payloads, build_sharded_video_codec, shard_frames,
    )

    codec = FusedVideoCodec(quantization_scale=args.q, search_range=args.search_range,
                            device=dev)
    with timer.stage("train", sync=y):
        codec.train(y[: min(2, T)])
        qs = codec.encode_gop(y[:gop])[0]
        codec.pack_gop(qs)  # establish the pack buckets
    cap, bw, gw = codec._buckets
    step = build_sharded_video_codec(mesh, codec, gop, band_h, W, cap, gw, bw)
    for start in range(0, T, n_gop * gop):
        chunk = y[start : start + n_gop * gop]
        with timer.stage("encode", sync=chunk):
            out = step(shard_frames(chunk, mesh))
        with timer.stage("serialize"):
            blobs.extend(assemble_video_payloads(codec, out, gop))
    for blob in blobs:
        with timer.stage("decode-check", sync=y):
            r, ok = FusedVideoCodec.decode_from_container(blob, device=dev)
            if not bool(ok):
                raise SystemExit("sharded GOP payload failed entropy decode")
            recons.append(r.cpu().numpy())
        bits.extend(int(b) for b in VideoPayload.from_bytes(blob).frame_bits)
    return blobs, recons, bits


def cmd_decode_video(args):
    """Reconstruct Y frames from a .ivc stream file alone."""
    from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec
    from ivclab_tpu_torch.models.videocodec import VideoCodec
    from ivclab_tpu_torch.runtime.container import KIND_VIDEO_ADAPTIVE

    dev = torch.device(args.device)
    on_device = torch.empty(0, device=dev)  # what each stage synchronises
    timer = _make_timer(args)
    blobs = read_video_stream(args.input)
    frames = []
    for blob in blobs:
        try:
            kind = _blob_kind(blob)
        except ValueError as e:
            raise SystemExit(f"corrupt stream entry: {e}")
        if kind == KIND_VIDEO_ADAPTIVE:
            with timer.stage("decode", sync=on_device):
                recons = VideoCodec.decode_from_container(blob, device=dev)
            frames.append(recons)
            continue
        with timer.stage("decode", sync=on_device):
            recons, ok = FusedVideoCodec.decode_from_container(blob, device=dev)
        if not bool(ok):
            raise SystemExit("corrupt GOP payload: entropy decode failed")
        frames.append(recons.cpu().numpy())
    out = np.clip(np.round(np.concatenate(frames)), 0, 255).astype(np.uint8)
    outp = Path(args.output)
    if outp.suffix == ".npy":
        np.save(outp, out)
    elif outp.suffix in (".mp4", ".avi", ".mkv"):
        # the reference's ch4 mp4 export; gray frames broadcast to RGB for
        # the writer
        from ivclab_tpu_torch.utils.io import write_video

        written = write_video(str(outp), np.repeat(out[..., None], 3, axis=-1))
        print(json.dumps({"video": written, "frames": int(out.shape[0])}))
        return
    else:
        from ivclab_tpu_torch.utils.io import imwrite

        outp.mkdir(parents=True, exist_ok=True)
        for t in range(out.shape[0]):
            imwrite(str(outp / f"frame{t:04d}.png"), out[t])
    rep = {"frames": int(out.shape[0]), "shape": list(out.shape[1:])}
    _add_trace(rep, timer, int(out.size))
    print(json.dumps(rep))


def cmd_rd_sweep(args):
    from ivclab_tpu_torch.config import SweepConfig
    from ivclab_tpu_torch.utils import fixtures

    dev = torch.device(args.device)
    sweep = SweepConfig()
    points = []
    if args.kind == "image":
        from ivclab_tpu_torch.models import IntraCodec

        train = fixtures.image("lena_small")
        img = fixtures.image("lena")
        for q in sweep.image_q_scales:
            codec = IntraCodec(quantization_scale=q, device=dev)
            codec.train_huffman_from_image(train)
            recon, _, _, bpp = codec.encode_decode(img, return_bpp=True)
            points.append({"q": q, "bpp": round(bpp, 4), "psnr_db": round(_psnr(img, recon), 3)})
    elif args.kind == "video":
        from ivclab_tpu_torch.models import VideoCodec

        frames = fixtures.video("foreman", num_frames=args.frames)
        for q in sweep.video_q_scales:
            codec = VideoCodec(quantization_scale=q, codebook_policy=args.codebook_policy,
                               device=dev)
            recons, bits = codec.encode_decode_sequence(frames)
            psnr = float(np.mean([_psnr(frames[t], recons[t]) for t in range(frames.shape[0])]))
            bpp = float(np.mean(bits / (frames[0].size / 3)))
            points.append({"q": q, "bpp": round(bpp, 4), "psnr_db": round(psnr, 3)})
    elif args.kind == "image-vs-video":
        # the reference's ch4 intra-vs-hybrid study: code each foreman frame
        # with a per-frame-trained IntraCodec at the image-codec q ladder;
        # the RD points pair with the `video` sweep
        from ivclab_tpu_torch.models import IntraCodec

        frames = fixtures.video("foreman", num_frames=args.frames)
        for q in sweep.image_vs_video_q_scales:
            codec = IntraCodec(quantization_scale=q, device=dev)
            psnrs, bpps = [], []
            for img in frames:
                codec.train_huffman_from_image(img)
                recon, _, _, bpp = codec.encode_decode(img, return_bpp=True)
                psnrs.append(_psnr(img, recon))
                bpps.append(bpp)
            points.append({
                "q": q,
                "bpp": round(float(np.mean(bpps)), 4),
                "psnr_db": round(float(np.mean(psnrs)), 3),
            })
    elif args.kind == "dpcm":
        from ivclab_tpu_torch.models.dpcm import PredictiveCodec

        img = fixtures.image("lena")
        for q in sweep.dpcm_quant_steps:
            recon, _, bpp = PredictiveCodec(quant_step=float(q), device=dev).encode_decode(
                img, return_bpp=True)
            points.append({"q": q, "bpp": round(bpp, 4), "psnr_db": round(_psnr(img, recon), 3)})
    else:
        raise SystemExit(f"unknown sweep kind {args.kind}")
    print(json.dumps({"kind": args.kind, "points": points}))


def _gop_info(blob: bytes) -> dict:
    from ivclab_tpu_torch.runtime.container import (
        KIND_VIDEO_ADAPTIVE, AdaptiveVideoPayload, VideoPayload,
    )

    if _blob_kind(blob) == KIND_VIDEO_ADAPTIVE:
        p = AdaptiveVideoPayload.from_bytes(blob)
        T, H, W = p.shape
        return {
            "kind": "video-gop-adaptive",
            "policy": "adaptive" if p.policy else "per-frame",
            "shape": [T, H, W],
            "quantization_scale": p.quantization_scale,
            "search_range": p.search_range,
            "payload_bits": p.payload_bits,
            "per_frame_bits": [int(b) for b in p.frame_bits],
            "per_frame_codebook_symbols": [int(cb.lengths.size) for cb, _ in p.frames],
            "container_bytes": p.container_bytes,
            "mean_bpp": round(p.payload_bits / (T * H * W), 4),
        }
    p = VideoPayload.from_bytes(blob)
    T, H, W = p.shape
    return {
        "kind": "video-gop",
        "shape": [T, H, W],
        "quantization_scale": p.quantization_scale,
        "search_range": p.search_range,
        "payload_bits": p.payload_bits,
        "per_frame_bits": [int(b) for b in p.frame_bits],
        "container_bytes": p.container_bytes,
        "residual_hot_symbols": int(p.residual_codebook.hot_values.size),
        "mean_bpp": round(p.payload_bits / (T * H * W), 4),
    }


def cmd_info(args):
    from ivclab_tpu_torch.runtime.container import (
        KIND_PFRAME, KIND_VIDEO_ADAPTIVE, KIND_VIDEO_GOP,
        IntraPayload, PFramePayload,
    )

    data = Path(args.input).read_bytes()
    if data[:4] == STREAM_MAGIC:
        infos = [_gop_info(blob) for blob in read_video_stream(args.input)]
        print(json.dumps({"kind": "video-stream", "gops": infos}))
        return
    if len(data) > 10 and data[:4] == b"IVC1" and data[6] in (KIND_VIDEO_ADAPTIVE, KIND_VIDEO_GOP):
        print(json.dumps(_gop_info(data)))
        return
    if len(data) > 10 and data[:4] == b"IVC1" and data[6] == KIND_PFRAME:
        p = PFramePayload.from_bytes(data)
        print(json.dumps({
            "kind": "p-frame",
            "shape": list(p.shape),
            "quantization_scale": p.quantization_scale,
            "search_range": p.search_range,
            "payload_bits": p.payload_bits,
            "container_bytes": p.container_bytes,
            "residual_codebook_symbols": int(p.residual_codebook.lengths.size),
        }))
        return
    p = IntraPayload.from_bytes(data)
    print(
        json.dumps(
            {
                "kind": p.kind,
                "shape": list(p.shape),
                "quantization_scale": p.quantization_scale,
                "num_symbols": p.num_symbols,
                "payload_bits": p.payload_bits,
                "container_bytes": p.container_bytes,
                "codebook_symbols": int(p.codebook.lengths.size),
                "layout": "grouped" if p.layout else "contiguous",
            }
        )
    )


def build_parser():
    ap = argparse.ArgumentParser(prog="ivclab_tpu_torch", description=__doc__)
    ap.add_argument(
        "--trace", action="store_true",
        help="emit per-stage timings + Mpix/s in the JSON report "
             "(StageTimer) and the port's ivc.* span totals under 'spans' "
             "(place before the subcommand)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device every codec runs on (place before the subcommand); "
             "the default needs a CUDA card, 'cpu' asks for the CPU",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("encode-image")
    p.add_argument("input"); p.add_argument("output")
    p.add_argument("--q", type=float, default=1.0)
    p.add_argument("--train", default=None)
    p.set_defaults(fn=cmd_encode_image)

    p = sub.add_parser("decode-image")
    p.add_argument("input"); p.add_argument("output")
    p.set_defaults(fn=cmd_decode_image)

    p = sub.add_parser("roundtrip-image")
    p.add_argument("input")
    p.add_argument("--q", type=float, default=1.0)
    p.add_argument("--train", default=None)
    p.set_defaults(fn=cmd_roundtrip_image)

    p = sub.add_parser("encode-video")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--q", type=float, default=1.0)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--gop", type=int, default=None)
    p.add_argument("--search-range", type=int, default=4)
    p.add_argument(
        "--codebook-policy", default="first-p-frame",
        choices=["first-p-frame", "per-frame", "adaptive"],
        help="first-p-frame: fused fixed-codebook GOP codec; "
             "per-frame/adaptive: per-frame codebooks in the container",
    )
    p.add_argument(
        "--mesh-gop", type=int, default=None,
        help="gop-axis size of the in-process mesh (sharded encode; "
             "config.MeshConfig.n_gop)",
    )
    p.add_argument(
        "--mesh-tile", type=int, default=None,
        help="tile-axis size of the in-process mesh (row-band sharding with "
             "halo motion search; config.MeshConfig.n_tile)",
    )
    p.set_defaults(fn=cmd_encode_video)

    p = sub.add_parser("decode-video")
    p.add_argument("input")
    p.add_argument("output", help=".npy file or a directory for PNG frames")
    p.set_defaults(fn=cmd_decode_video)

    p = sub.add_parser("rd-sweep")
    p.add_argument(
        "--kind", default="image",
        choices=["image", "video", "dpcm", "image-vs-video"],
    )
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--codebook-policy", default="per-frame")
    p.set_defaults(fn=cmd_rd_sweep)

    p = sub.add_parser("info")
    p.add_argument("input")
    p.set_defaults(fn=cmd_info)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.trace:
        return args.fn(args)
    from ivclab_tpu_torch.runtime import trace

    was_on = trace.enable()
    try:
        return args.fn(args)
    finally:
        if not was_on:
            trace.disable()


if __name__ == "__main__":
    sys.exit(main())
