"""Multi-shard dry run of the full sharded video codec.

Port of ``dryrun_multichip`` in the repository's ``__graft_entry__.py``:

    python3 -m ivclab_tpu_torch.tools.dryrun N [--device cuda|cpu]

builds an ``N``-shard ``(gop, tile)`` mesh (JAX ``make_mesh``'s default
factorisation: at most 4 shards on ``tile``) and runs one full sharded
video encode step on tiny shapes: trained hot/escape codebooks, the halo
motion search, per-shard entropy packing and the bitstream assembly. It
asserts that the gathered stream equals the single-device fused pack word
for word, that the assembled container decodes within 1e-2 of the
encoder's reconstruction, and that ``ShardedAdaptiveEncoder``'s first GOP
equals ``VideoCodec(..., "per-frame").encode_to_container``'s bytes.

The mesh is in-process on ``device`` (every shard on one card, or the
CPU); with ``distributed=True`` it is one shard per rank of the
initialised default process group, and ``N`` must be its world size.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     distributed: bool = False) -> None:
    from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec
    from ivclab_tpu_torch.models.videocodec import VideoCodec
    from ivclab_tpu_torch.parallel.mesh import _factor, make_mesh
    from ivclab_tpu_torch.parallel.video import (
        ShardedAdaptiveEncoder,
        assemble_video_payloads,
        build_sharded_video_codec,
        shard_frames,
    )
    from ivclab_tpu_torch.utils import fixtures

    if distributed:
        mesh = make_mesh(*_factor(n_devices, None, None), distributed=True)
        if mesh.n_gop * mesh.n_tile != n_devices:
            raise ValueError(f"{n_devices} shards on a world of {mesh.n_gop * mesh.n_tile}")
    else:
        mesh = make_mesh(*_factor(n_devices, None, None), device=device)
    dev = mesh.device
    n_gop, n_tile = mesh.n_gop, mesh.n_tile

    # rows per tile band: 16 blocks a band at least (one pack group), scaled
    # so the frame stays >= 64 px tall for the synthetic-motion fixture
    band_h = max(16, 64 // n_tile)
    W = 64
    gop_len = 2
    H = band_h * n_tile
    T = n_gop * gop_len

    frames = fixtures.video("dryrun", num_frames=T, shape=(H, W))
    y = np.ascontiguousarray(frames.astype(np.float32).mean(axis=-1))

    # trained codebooks (residual + MV): real distributed entropy coding
    codec = FusedVideoCodec(quantization_scale=1.0, device=dev).train(y[:2])

    # the single-device fused reference on GOP 0 (also picks the pack buckets)
    qs0, mvs0, _, _ = codec.encode_gop(y[:gop_len])
    p0 = codec.pack_gop(qs0)
    cap, bw, gw = codec._buckets

    step = build_sharded_video_codec(mesh, codec, gop_len, band_h, W, cap, gw, bw)
    out = step(shard_frames(y, mesh))

    assert tuple(out.recons.shape) == (T, H, W), tuple(out.recons.shape)
    assert bool(torch.isfinite(out.recons).all()), "non-finite reconstruction"
    assert int(out.totals[0]) > 0, "zero bits coded"
    # the gathered multi-shard stream == the single-device stream
    assert torch.equal(out.words[:gop_len].to(p0.words.dtype), p0.words), (
        "sharded group substreams differ from the fused single-device pack"
    )
    assert torch.equal(out.mvs[:gop_len], mvs0)

    # assembly -> container bytes -> decode from the bytes alone
    payloads = assemble_video_payloads(codec, out, gop_len)
    assert len(payloads) == n_gop
    recons, ok = FusedVideoCodec.decode_from_container(payloads[0], device=dev)
    assert bool(ok), "entropy decode failed"
    err = float((recons - out.recons[:gop_len]).abs().max())
    assert err < 1e-2, f"container decode mismatch: {err}"

    # the per-frame adaptive sharded path: per-frame codebooks on the same
    # mesh; its bytes must equal the single-device adaptive encoder's
    adaptive = ShardedAdaptiveEncoder(mesh, gop_len, band_h, W, quantization_scale=1.0)
    ablobs = adaptive.encode(y)
    assert len(ablobs) == n_gop
    ref_blob = VideoCodec(quantization_scale=1.0, codebook_policy="per-frame",
                          device=dev).encode_to_container(y[:gop_len])
    assert ablobs[0] == ref_blob, (
        "sharded adaptive container differs from the single-device encoder"
    )
    arec = VideoCodec.decode_from_container(ablobs[0], device=dev)
    assert arec.shape == (gop_len, H, W)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    print(f"dryrun_multichip({args.n_devices}) on {args.device}: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
