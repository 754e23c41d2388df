"""The ``(gop, tile)`` mesh of the sharded codec, in one process or over ranks.

Port of ``ivclab_tpu/parallel/mesh.py``. The codec shards along the two
independence structures it has:

- ``gop``  — groups of pictures. Each GOP opens with an I-frame, so the
  P-frame recursion through the decoder reconstruction never crosses
  shards.
- ``tile`` — row bands of a frame. Transform, quantisation and zero-run
  coding are blockwise and need no communication; motion estimation needs
  a ±search_range halo of the reconstructed reference from the neighbouring
  bands.

A mesh runs in one of two modes, chosen by the caller and never as a
fallback:

- **in-process** (``make_mesh(..., device=...)``): every (gop, tile) shard
  runs in this process on one device. This is how one card runs a
  multi-shard mesh, and the counterpart of the JAX tests' virtual CPU mesh.
- **distributed** (``make_mesh(..., distributed=True)`` after
  :func:`init_distributed`): one shard per rank of the default
  ``torch.distributed`` process group, rank ``g * n_tile + i`` holding
  shard ``(g, i)``; halos travel as point-to-point messages and the tile
  reduction is an ``all_reduce`` over each GOP's tile group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A ``gop × tile`` grid of shards.

    ``rank`` is None in-process (every shard lives here); in distributed
    mode it is this process's rank and ``tile_groups[g]`` the process group
    of GOP row ``g``.
    """

    n_gop: int
    n_tile: int
    device: torch.device
    rank: int | None = None
    tile_groups: tuple = field(default=(), repr=False)

    @property
    def shape(self) -> dict:
        return {"gop": self.n_gop, "tile": self.n_tile}

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    def local_shards(self) -> list[tuple[int, int]]:
        """The (gop, tile) shards this process computes, gop-major."""
        if self.rank is None:
            return [(g, i) for g in range(self.n_gop) for i in range(self.n_tile)]
        return [divmod(self.rank, self.n_tile)]


def _factor(n: int, n_gop: int | None, n_tile: int | None) -> tuple[int, int]:
    """JAX ``make_mesh``'s factorisation: at most 4 shards on ``tile`` (the
    halo exchange is nearest-neighbour), the rest on ``gop``."""
    if n_gop is None and n_tile is None:
        n_tile = next(c for c in (4, 2, 1) if n % c == 0)
        n_gop = n // n_tile
    elif n_gop is None:
        n_gop = n // n_tile
    elif n_tile is None:
        n_tile = n // n_gop
    if n_gop * n_tile != n:
        raise ValueError(f"mesh {n_gop}x{n_tile} != {n} shards")
    return n_gop, n_tile


def make_mesh(n_gop: int | None = None, n_tile: int | None = None, *,
              device: str | torch.device = "cuda", distributed: bool = False) -> Mesh:
    """Build a ``(gop, tile)`` mesh.

    In-process (the default): ``n_gop * n_tile`` shards on ``device``.
    Distributed: one shard per rank of the initialised default process
    group, missing axis sizes following JAX's default factorisation of the
    world size; the device is the current CUDA device under NCCL and the
    CPU under gloo.
    """
    if distributed:
        if not dist.is_initialized():
            raise RuntimeError("distributed mesh needs init_distributed() first")
        n = dist.get_world_size()
        n_gop, n_tile = _factor(n, n_gop, n_tile)
        if dist.get_backend() == "nccl":
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device("cpu")
        # every rank creates every group, in the same order
        groups = tuple(dist.new_group(list(range(g * n_tile, (g + 1) * n_tile)))
                       for g in range(n_gop))
        return Mesh(n_gop, n_tile, dev, dist.get_rank(), groups)
    if n_gop is None or n_tile is None or n_gop < 1 or n_tile < 1:
        raise ValueError(f"an in-process mesh needs both axis sizes, got {n_gop}x{n_tile}")
    return Mesh(n_gop, n_tile, torch.device(device))


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None) -> bool:
    """Join the ``torch.distributed`` process group of a multi-process run.

    Arguments default to the ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` environment (``init_method`` becomes
    ``tcp://MASTER_ADDR:MASTER_PORT``). The backend is NCCL where CUDA is
    available, with this process on card ``LOCAL_RANK`` (else ``rank``
    modulo the card count), and gloo elsewhere. Returns True
    when a process group was joined, False when nothing is set (a single
    process: nothing to do).
    """
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None and world_size is None:
        return False
    if init_method is None or world_size is None or rank is None:
        raise ValueError("init_distributed needs an address, a world size and a rank")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return True
