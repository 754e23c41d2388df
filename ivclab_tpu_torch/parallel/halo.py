"""Halo exchange and band-local motion estimation / compensation.

Port of ``ivclab_tpu/parallel/halo.py``. A frame's rows are split into
bands across the mesh's ``tile`` axis; full-search motion estimation needs
``search_range`` rows of the reconstructed reference from each
neighbouring band. Once those halos are in place every band runs the
search locally, and the result equals the whole-frame search.

The JAX package's select-based ``motion_compensate_tile_dense`` avoided
TPU gathers; here :func:`motion_compensate_tile` (a gather) stands for both
forms, which give the same pixels on the fields the encoder emits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ivclab_tpu_torch.ops.motion import BLOCK, motion_search_tile
from ivclab_tpu_torch.parallel.mesh import Mesh

__all__ = ["exchange_row_halo", "motion_search_tile", "motion_compensate_tile"]


def exchange_row_halo(bands: list[torch.Tensor], halo: int, mesh: Mesh) -> list[torch.Tensor]:
    """Append ``halo`` rows from the neighbouring bands above and below.

    ``bands`` are the ``[Ht, W]`` bands of one GOP that this process holds,
    in tile order: all ``n_tile`` of them in-process, this rank's one in
    distributed mode (its neighbours are ranks ``rank ± 1`` of the same GOP
    row). Returns the ``[Ht + 2*halo, W]`` extended bands; frame edges are
    zero-filled (the search masks every candidate that reads them).
    """
    def zeros():
        return bands[0].new_zeros((halo, bands[0].shape[1]))

    if not mesh.distributed:
        n = len(bands)
        if n != mesh.n_tile:
            raise ValueError(f"{n} bands for a tile axis of {mesh.n_tile}")
        return [
            torch.cat([bands[i - 1][-halo:] if i > 0 else zeros(), band,
                       bands[i + 1][:halo] if i < n - 1 else zeros()])
            for i, band in enumerate(bands)
        ]

    (band,) = bands
    i = mesh.rank % mesh.n_tile
    from_above, from_below = zeros(), zeros()
    ops = []
    if i > 0:  # my top rows become the bottom halo of the band above
        ops += [dist.P2POp(dist.isend, band[:halo].contiguous(), mesh.rank - 1),
                dist.P2POp(dist.irecv, from_above, mesh.rank - 1)]
    if i < mesh.n_tile - 1:
        ops += [dist.P2POp(dist.isend, band[-halo:].contiguous(), mesh.rank + 1),
                dist.P2POp(dist.irecv, from_below, mesh.rank + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [torch.cat([from_above, band, from_below])]


def motion_compensate_tile(ref_ext: torch.Tensor, motion_idx: torch.Tensor,
                           search_range: int = 4) -> torch.Tensor:
    """Band-local MC: gather each block's displaced pixels from the
    halo-extended reference band ``[Ht + 2 sr, W]`` -> ``[Ht, W]``."""
    sr = search_range
    Hext, W = ref_ext.shape
    Ht = Hext - 2 * sr
    total = 2 * sr + 1
    mv = motion_idx.to(device=ref_ext.device, dtype=torch.int64)
    dy = torch.div(mv, total, rounding_mode="floor") - sr
    dx = torch.remainder(mv, total) - sr
    dy_pix = dy.repeat_interleave(BLOCK, 0).repeat_interleave(BLOCK, 1)
    dx_pix = dx.repeat_interleave(BLOCK, 0).repeat_interleave(BLOCK, 1)
    rows = torch.arange(Ht, device=ref_ext.device)[:, None]
    cols = torch.arange(W, device=ref_ext.device)[None, :]
    yy = (rows + sr + dy_pix).clamp(0, Hext - 1)
    xx = (cols + dx_pix).clamp(0, W - 1)
    return ref_ext[yy, xx]
