"""Zero-run-length coding of scan-ordered coefficient blocks, per block.

Port of ``ivclab_tpu/ops/zerorun.py`` (``zerorun_counts``,
``zerorun_encode_blocks_dense``, ``zerorun_decode_blocks_dense``). Every
block is coded independently and closed by an EOB symbol, so both
directions are data-parallel over all blocks at once.

Symbol grammar:
  value v != 0      -> "v"
  run of k zeros    -> "0 k"     (only runs before the last nonzero)
  trailing zeros    -> dropped, block closed by the EOB symbol

The JAX package deposits symbols with one-hot broadcast reductions
(``[N, 64, cap]``); here the same integers come from ``scatter_add_`` into
a spare trash column, which sums exactly as the one-hot form does and
drops what falls outside the buffer.
"""

from __future__ import annotations

import torch

# Worst case symbols per 64-coeff block: 32 isolated zeros (2 each) +
# 32 values + EOB = 97, padded to 128.
BLOCK_CAP = 128
DEFAULT_EOB = 4000


def _classify(x: torch.Tensor, block_size: int):
    """Per-position emit counts of the encoder grammar."""
    N = x.shape[0]
    pos = torch.arange(block_size, dtype=torch.int32, device=x.device)
    nz = x != 0
    last_nz = torch.where(nz, pos[None, :], -1).amax(dim=1)
    in_range = pos[None, :] <= last_nz[:, None]
    prev_nz = torch.cat([torch.ones((N, 1), dtype=torch.bool, device=x.device), nz[:, :-1]], 1)
    is_value = nz & in_range
    run_start = in_range & ~nz & prev_nz
    emit = is_value.to(torch.int32) + 2 * run_start.to(torch.int32)
    return pos, nz, is_value, run_start, emit


def zerorun_counts(zz: torch.Tensor, block_size: int = 64) -> torch.Tensor:
    """Per-block symbol counts (incl. EOB) without building the buffers."""
    x = zz.to(torch.int32)
    *_, emit = _classify(x, block_size)
    return emit.sum(dim=1, dtype=torch.int32) + 1


def zerorun_encode_blocks_dense(zz: torch.Tensor, block_size: int = 64,
                                eob: int = DEFAULT_EOB, cap: int = BLOCK_CAP):
    """Encode ``[N, block_size]`` int blocks into ``[N, cap]`` symbol buffers.

    Returns ``(buf, valid_len)``: symbols left-packed per row, and the true
    per-block symbol count including the EOB. Symbols past ``cap`` are
    dropped, so ``cap`` should be at least the largest count.
    """
    x = zz.to(torch.int32)
    N = x.shape[0]
    pos, nz, is_value, run_start, emit = _classify(x, block_size)

    # next nonzero at or after each position (the run end)
    idx_if_nz = torch.where(nz, pos[None, :], block_size)
    next_nz = torch.flip(torch.cummin(torch.flip(idx_if_nz, [1]), dim=1).values, [1])
    run_len = next_nz - pos[None, :]

    csum = torch.cumsum(emit, dim=1, dtype=torch.int32)
    off = csum - emit
    total = csum[:, -1]
    valid_len = total + 1

    val1 = torch.where(is_value, x, 0)
    val2 = torch.where(run_start, run_len, 0)
    buf = torch.zeros((N, cap + 1), dtype=torch.int32, device=x.device)  # col cap: trash
    # values at slot off, run lengths at off + 1 (markers are literal zeros)
    buf.scatter_add_(1, torch.where(off < cap, off, cap).long(), val1)
    buf.scatter_add_(1, torch.where(off + 1 < cap, off + 1, cap).long(), val2)
    eob_col = torch.where(total < cap, total, cap).long()[:, None]
    buf.scatter_add_(1, eob_col, torch.full((N, 1), eob, dtype=torch.int32, device=x.device))
    return buf[:, :cap], valid_len


def zerorun_decode_blocks_dense(buf: torch.Tensor, valid_len: torch.Tensor,
                                block_size: int = 64, eob: int = DEFAULT_EOB):
    """Decode per-block symbol buffers ``[N, cap]`` -> ``[N, block_size]``.

    Also returns ``ok``, a device bool: every block is EOB-terminated and
    no block overflows ``block_size`` coefficients.
    """
    s = buf.to(torch.int32)
    N, cap = s.shape
    dev = s.device
    pos = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    valid_len = valid_len.to(device=dev, dtype=torch.int32)
    valid = pos < valid_len[:, None]

    is_eob = (s == eob) & valid
    is_marker = (s == 0) & valid & ~is_eob
    prev_marker = torch.cat([torch.zeros((N, 1), dtype=torch.bool, device=dev), is_marker[:, :-1]], 1)
    is_runlen = prev_marker & valid
    is_value = valid & ~is_eob & ~is_marker & ~is_runlen

    run_next = torch.cat([s[:, 1:], torch.zeros((N, 1), dtype=torch.int32, device=dev)], 1)
    contributed = torch.where(is_marker, run_next, is_value.to(torch.int32))
    csum = torch.cumsum(contributed, dim=1, dtype=torch.int32)
    coeff_pos = csum - contributed

    # values land at min(coeff_pos, block_size - 1); negative positions
    # (hostile run lengths) and non-values go to the trash column
    keep = is_value & (coeff_pos >= 0)
    cpos = torch.where(keep, coeff_pos.clamp(max=block_size - 1), block_size)
    out = torch.zeros((N, block_size + 1), dtype=torch.int32, device=dev)
    out.scatter_add_(1, cpos.long(), s)

    last = (valid_len - 1).clamp(0, cap - 1).long()[:, None]
    terminated = (valid_len > 0) & (torch.gather(s, 1, last)[:, 0] == eob)
    no_overflow = torch.where(valid, coeff_pos + contributed <= block_size, True).all()
    ok = terminated.all() & no_overflow
    return out[:, :block_size], ok
