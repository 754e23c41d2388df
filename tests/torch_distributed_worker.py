"""Worker process of the two-process ``torch.distributed`` codec test.

Launched by ``tests/test_torch_distributed.py`` with ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` in its environment, which is
what ``ivclab_tpu_torch.parallel.init_distributed`` reads. The two ranks
form a ``gop=1 × tile=2`` mesh over gloo, so the tile axis crosses the
process boundary: the halo exchange, the per-frame bit reduction and the
stream gather are real messages between the processes. Each rank packs its
own band; rank 0 assembles the container bytes of two GOPs and writes them
(length-prefixed) to the output path. With ``adaptive`` the ranks run
``ShardedAdaptiveEncoder`` (per-frame codebooks) instead of the fixed-code
codec, and then ``tools.dryrun.dryrun_multichip(2, distributed=True)``
over the same two ranks. Before they finish, the ranks exchange
heartbeats through the process group's store
(``runtime.elastic.DistributedHeartbeat``) and each must see both alive.
Imports nothing of JAX.

    python tests/torch_distributed_worker.py OUT CAP BLOCK_WORDS GROUP_WORDS
    python tests/torch_distributed_worker.py OUT adaptive
"""

from __future__ import annotations

import struct
import sys


def main() -> int:
    out_path = sys.argv[1]
    adaptive = sys.argv[2] == "adaptive"

    import numpy as np
    import torch
    import torch.distributed as dist

    from ivclab_tpu_torch import FusedVideoCodec
    from ivclab_tpu_torch.parallel import (
        ShardedAdaptiveEncoder,
        assemble_video_payloads,
        build_sharded_video_codec,
        init_distributed,
        make_mesh,
        shard_frames,
    )
    from ivclab_tpu_torch.runtime.elastic import DistributedHeartbeat
    from ivclab_tpu_torch.tools.dryrun import dryrun_multichip
    from ivclab_tpu_torch.utils import fixtures

    torch.set_num_threads(1)
    assert init_distributed() is True, "init_distributed must report multi-process"
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
    mesh = make_mesh(1, 2, distributed=True)
    assert mesh.local_shards() == [(0, dist.get_rank())]

    T, H, W, gop_len = 4, 64, 64, 2
    frames = fixtures.video("dist", num_frames=T, shape=(H, W))
    y = np.ascontiguousarray(frames.astype(np.float32).mean(axis=-1))
    blobs = []
    if adaptive:
        enc = ShardedAdaptiveEncoder(mesh, gop_len, H // 2, W)
        for g in range(T // gop_len):  # one GOP per call on a one-GOP mesh
            blobs += enc.encode(y[g * gop_len:(g + 1) * gop_len])
        dryrun_multichip(2, distributed=True)  # raises on any failed check
    else:
        cap, bw, gw = (int(x) for x in sys.argv[2:5])
        # the same deterministic training on every rank
        codec = FusedVideoCodec(quantization_scale=1.0, device="cpu").train(y[:2])
        step = build_sharded_video_codec(mesh, codec, gop_len, H // 2, W, cap, gw, bw)
        for g in range(T // gop_len):  # one GOP per step on a one-GOP mesh
            streams = step(shard_frames(y[g * gop_len:(g + 1) * gop_len], mesh))
            blobs += assemble_video_payloads(codec, streams, gop_len)
    if dist.get_rank() == 0:
        with open(out_path, "wb") as f:
            for blob in blobs:
                f.write(struct.pack("<Q", len(blob)) + blob)
    dist.barrier()
    heartbeat = DistributedHeartbeat()  # the default process group's store
    assert heartbeat.report() == 1
    dist.barrier()  # both ranks have reported
    assert heartbeat.poll() == {0: 1, 1: 1}, heartbeat.poll()
    assert heartbeat.alive_hosts() == [0, 1] and heartbeat.dead_hosts() == []
    dist.barrier()
    print(f"WORKER_OK {dist.get_rank()}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
