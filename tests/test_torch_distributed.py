"""Two processes over ``torch.distributed`` (gloo): the port's twin of
tests/test_distributed.py.

Two worker processes join one process group through the environment
``init_distributed`` reads and run the sharded codec on a ``gop=1 ×
tile=2`` mesh whose tile axis crosses the process boundary: the fixed-code
sharded codec, and the per-frame adaptive ``ShardedAdaptiveEncoder``.
Rank 0's container bytes must equal the port's in-process bytes and the
JAX package's single-process bytes.
"""

from __future__ import annotations

import os
import socket
import struct
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from torch_parity import RECON_TOL, assert_close, reference_state

from ivclab_tpu.models.fastvideo import FusedVideoCodec as JaxCodec
from ivclab_tpu.models.videocodec import VideoCodec as JaxVideo
from ivclab_tpu.utils import fixtures

from ivclab_tpu_torch import FusedVideoCodec as TorchCodec
from ivclab_tpu_torch import parallel as tpar

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _frames():
    frames = fixtures.video("dist", num_frames=4, shape=(64, 64))
    return np.ascontiguousarray(frames.astype(np.float32).mean(axis=-1))


def _run_workers(tmp_path, *args) -> list:
    """Start the two gloo workers with ``args``; rank 0's blobs."""
    out = tmp_path / "payloads.bin"
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), PYTHONPATH=os.pathsep.join(
                       filter(None, [str(REPO), os.environ.get("PYTHONPATH", "")])))
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_distributed_worker.py"), str(out), *args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outputs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, stdout) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{stdout[-4000:]}"
        assert f"WORKER_OK {rank}" in stdout

    data, off, blobs = out.read_bytes(), 0, []
    while off < len(data):
        (n,) = struct.unpack_from("<Q", data, off)
        blobs.append(data[off + 8:off + 8 + n])
        off += 8 + n
    return blobs


def test_two_gloo_processes_give_the_single_process_bytes(tmp_path):
    y = _frames()
    j = JaxCodec(quantization_scale=1.0).train(y[:2])
    golden = []
    for g in range(2):
        qs, mvs, _, _ = j.encode_gop(jnp.asarray(y[g * 2:(g + 1) * 2]))
        golden.append(j.container_from_packed(j.pack_gop(qs), mvs, (2, 64, 64)))
    cap, bw, gw = j._buckets

    t = TorchCodec.from_reference_state(reference_state(j), device="cpu")
    mesh = tpar.make_mesh(1, 2, device="cpu")
    step = tpar.build_sharded_video_codec(mesh, t, 2, 32, 64, cap, gw, bw)
    in_process = []
    for g in range(2):
        streams = step(tpar.shard_frames(y[g * 2:(g + 1) * 2], mesh))
        in_process += tpar.assemble_video_payloads(t, streams, 2)
    assert in_process == golden

    blobs = _run_workers(tmp_path, str(cap), str(bw), str(gw))
    assert blobs == golden  # the two-process stream IS the single-process stream
    for g, blob in enumerate(blobs):
        recons, ok = TorchCodec.decode_from_container(blob, device="cpu")
        jrec, jok = JaxCodec.decode_from_container(blob)
        assert bool(ok) and bool(jok)
        assert_close(recons, np.asarray(jrec), RECON_TOL, f"GOP {g} decode")


def test_two_gloo_processes_give_the_single_device_adaptive_bytes(tmp_path):
    """``ShardedAdaptiveEncoder`` with the tile axis across the two
    processes: its per-tile statistics meet in MIN/MAX/SUM all-reduces and
    its sidecars and words in all-gathers, and the bytes are the JAX
    package's single-device ``encode_to_container`` bytes of each GOP."""
    y = _frames()
    golden = [JaxVideo(1.0).encode_to_container(y[g * 2:(g + 1) * 2]) for g in range(2)]
    mesh = tpar.make_mesh(1, 2, device="cpu")
    enc = tpar.ShardedAdaptiveEncoder(mesh, 2, 32, 64)
    assert [b for g in range(2) for b in enc.encode(y[g * 2:(g + 1) * 2])] == golden
    assert _run_workers(tmp_path, "adaptive") == golden
