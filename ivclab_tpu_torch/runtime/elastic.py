"""Failure detection and elastic recovery for distributed encoding.

Port of ``ivclab_tpu/runtime/elastic.py``. Every GOP opens with an
I-frame, so no coding state crosses GOP boundaries: a lost host
invalidates only its own GOPs, which any surviving host re-encodes
bit-identically.

- :class:`HeartbeatMonitor` keeps host liveness for the encode loop that
  hands out GOPs (no transport; usable directly in tests), and
  :class:`DistributedHeartbeat` carries it over a ``torch.distributed``
  key-value store: each process reports after its GOP step, and polling
  never blocks on a dead peer.
- :func:`reencode_missing_gops` fills the holes of a per-GOP payload list
  by re-encoding just the missing GOPs through a single-device codec;
  the distributed pack equals the fused pack, so the recovered payloads
  are what the lost host would have written.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class HeartbeatMonitor:
    """Tracks per-host liveness from periodic heartbeat reports."""

    def __init__(self, hosts, timeout_s: float = 30.0, clock=time.monotonic):
        self.timeout_s = float(timeout_s)
        self._clock = clock
        now = clock()
        self._last_seen = {h: now for h in hosts}

    def report(self, host) -> None:
        """Record a heartbeat from ``host`` (unknown hosts auto-register)."""
        self._last_seen[host] = self._clock()

    def dead_hosts(self) -> list:
        """Hosts whose last heartbeat is older than the timeout."""
        now = self._clock()
        return [h for h, t in self._last_seen.items() if now - t > self.timeout_s]

    def alive_hosts(self) -> list:
        now = self._clock()
        return [h for h, t in self._last_seen.items() if now - t <= self.timeout_s]


class DistributedHeartbeat:
    """Heartbeats over a ``torch.distributed`` key-value store.

    After every GOP step each process overwrites its key with a
    monotonically increasing sequence number (``store.set``), and any
    process can :meth:`poll` every peer's key: a key is read only after
    ``store.check`` finds it, so a peer that has not reported, or has died,
    never blocks the poll. The store lives in the rendezvous server, not in
    the peers. A peer whose number stops advancing ages out of the monitor
    and lands in :meth:`dead_hosts`, and the encode loop re-encodes its GOPs
    through :func:`reencode_missing_gops`.

    The store defaults to the default process group's; ``store=`` takes any
    ``torch.distributed.Store`` (``rank`` and ``world_size`` then default to
    the process group's too). Runs across two gloo processes in
    ``tests/torch_distributed_worker.py``.
    """

    def __init__(self, monitor: HeartbeatMonitor | None = None,
                 prefix: str = "ivclab/heartbeat", store=None, timeout_s: float = 30.0,
                 rank: int | None = None, world_size: int | None = None):
        import torch.distributed as dist
        from torch.distributed import distributed_c10d

        if store is None or rank is None or world_size is None:
            if not dist.is_available() or not dist.is_initialized():
                raise RuntimeError(
                    "torch.distributed is not initialized (call "
                    "ivclab_tpu_torch.parallel.mesh.init_distributed first)"
                )
        self.store = store if store is not None else distributed_c10d._get_default_store()
        self.prefix = prefix
        self.process_id = dist.get_rank() if rank is None else int(rank)
        self.num_processes = dist.get_world_size() if world_size is None else int(world_size)
        self.monitor = monitor or HeartbeatMonitor(range(self.num_processes), timeout_s=timeout_s)
        self._seq = 0
        self._seen: dict[int, int] = {}

    def _key(self, p: int) -> str:
        return f"{self.prefix}/{p}"

    def report(self) -> int:
        """Publish this process's next heartbeat sequence number."""
        self._seq += 1
        self.store.set(self._key(self.process_id), str(self._seq))
        self.monitor.report(self.process_id)
        return self._seq

    def poll(self) -> dict:
        """Read every peer's stamp; advancing stamps refresh the monitor.

        Returns ``{process_id: last_seen_sequence}`` for the peers that
        have ever reported."""
        for p in range(self.num_processes):
            if not self.store.check([self._key(p)]):
                continue  # the peer has not reported yet
            seq = int(self.store.get(self._key(p)))
            if self._seen.get(p) != seq:
                self._seen[p] = seq
                self.monitor.report(p)
        return dict(self._seen)

    def dead_hosts(self) -> list:
        return self.monitor.dead_hosts()

    def alive_hosts(self) -> list:
        return self.monitor.alive_hosts()


def reencode_missing_gops(codec, frames_y, payloads, gop_len: int) -> list:
    """Replace ``None`` holes in a per-GOP payload list by re-encoding.

    ``frames_y``: the full ``[T, H, W]`` luma stack (T = len(payloads) *
    gop_len), numpy or a tensor; ``payloads``: per-GOP container bytes with
    ``None`` where a host was lost. Returns the completed list. Only the
    missing GOPs are re-encoded: the recovery cost is proportional to the
    failure, not the job.
    """
    if not isinstance(frames_y, torch.Tensor):
        frames_y = np.asarray(frames_y)
    out = list(payloads)
    for g, blob in enumerate(out):
        if blob is not None:
            continue
        chunk = frames_y[g * gop_len:(g + 1) * gop_len]
        out[g] = codec.encode_to_container(chunk)
    return out
