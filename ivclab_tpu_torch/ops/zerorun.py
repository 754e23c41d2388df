"""Zero-run-length coding of scan-ordered coefficient blocks, per block.

Port of ``ivclab_tpu/ops/zerorun.py``. Every block is coded independently
and closed by an EOB symbol, so both directions are data-parallel over all
blocks at once: per-block buffers (``zerorun_encode_blocks``,
``zerorun_decode_blocks``), and the compact stream of all blocks
(``compact_symbols``, ``zerorun_decode_stream``: a global segmented prefix
sum).

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

import numpy as np
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


def zerorun_encode_blocks(zz: torch.Tensor, block_size: int = 64,
                          eob: int = DEFAULT_EOB, cap: int = BLOCK_CAP):
    """Encode ``[N, block_size]`` int blocks into ``[N, cap]`` symbol buffers.

    Returns ``(buf, valid_len)``: symbols left-packed per row, and the true
    per-block symbol count including the EOB. Symbols past ``cap`` are
    dropped, so ``cap`` should be at least the largest count. The one
    counterpart of the JAX package's ``zerorun_encode_blocks`` (fixed
    ``BLOCK_CAP``) and ``zerorun_encode_blocks_dense`` (any ``cap``).
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


def zerorun_decode_blocks(buf: torch.Tensor, valid_len: torch.Tensor,
                          block_size: int = 64, eob: int = DEFAULT_EOB):
    """Decode per-block symbol buffers ``[N, cap]`` -> ``[N, block_size]``.

    Also returns ``ok``, a device bool: every block is EOB-terminated and
    no block overflows ``block_size`` coefficients. The one counterpart of
    the JAX package's ``zerorun_decode_blocks`` and
    ``zerorun_decode_blocks_dense`` (the same integers and ``ok``).
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


def compact_symbols(buf: torch.Tensor, valid_len: torch.Tensor):
    """Left-pack per-block symbol buffers into one padded stream.

    Returns ``(stream, total)``: ``stream`` has the capacity of ``buf``
    flattened, with every block's symbols concatenated in block order at
    the front and zeros after; ``total`` (a 0-d tensor) is the symbol count.
    """
    N, cap = buf.shape
    dev = buf.device
    valid_len = valid_len.to(device=dev, dtype=torch.int64)
    starts = torch.cumsum(valid_len, 0) - valid_len
    total = valid_len.sum() if N else torch.zeros((), dtype=torch.int64, device=dev)
    pos = torch.arange(cap, device=dev)
    valid = pos[None, :] < valid_len[:, None]
    # padded slots write to a trash copy of their own position: no two
    # writes share an address
    trash = N * cap + torch.arange(N, device=dev)[:, None] * cap + pos[None, :]
    tgt = torch.where(valid, starts[:, None] + pos[None, :], trash)
    out = torch.zeros(2 * N * cap, dtype=buf.dtype, device=dev)
    out[tgt.reshape(-1)] = buf.reshape(-1)
    return out[: N * cap], total


def _cummax(v: torch.Tensor, row: int = 1024) -> torch.Tensor:
    """Running maximum of a 1-D int32 tensor, in two levels: within rows of
    ``row`` elements, then each row raised to the maximum of the rows before
    it (max is associative, so the values are exactly ``torch.cummax``'s; a
    single long 1-D scan runs on one CUDA block)."""
    n = v.shape[0]
    lowest = torch.iinfo(v.dtype).min
    x = torch.cat([v, v.new_full(((-n) % row,), lowest)]).reshape(-1, row)
    within = torch.cummax(x, dim=1).values
    before = torch.cummax(within[:, -1], dim=0).values
    before = torch.cat([before.new_full((1,), lowest), before[:-1]])
    return torch.maximum(within, before[:, None]).reshape(-1)[:n]


def zerorun_decode_stream(stream: torch.Tensor, num_symbols, num_blocks: int,
                          block_size: int = 64, eob: int = DEFAULT_EOB):
    """Decode a (padded) symbol stream back to ``[num_blocks, block_size]``.

    ``stream``: 1-D, the first ``num_symbols`` entries valid. Symbols are
    classified by position (EOB, run marker, run length, value), a global
    prefix sum of the coefficients each contributes, rebased at every
    block start by a running maximum, gives each value its position, and
    one scatter rebuilds the blocks. Also returns ``ok``, a device bool:
    the stream holds ``num_blocks`` EOBs and no block overflows.
    """
    s = stream.to(torch.int32).reshape(-1)
    L = s.shape[0]
    dev = s.device
    pos = torch.arange(L, device=dev)
    valid = pos < torch.as_tensor(num_symbols, device=dev)

    is_eob = (s == eob) & valid
    block_id = torch.cumsum(is_eob.to(torch.int64), 0) - is_eob.to(torch.int64)
    is_marker = (s == 0) & valid & ~is_eob
    prev_marker = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), is_marker[:-1]])
    is_runlen = prev_marker & valid
    is_value = valid & ~is_eob & ~is_marker & ~is_runlen

    run_next = torch.cat([s[1:], torch.zeros(1, dtype=torch.int32, device=dev)])
    contributed = torch.where(is_marker, run_next, is_value.to(torch.int32))
    excl = torch.cumsum(contributed, 0, dtype=torch.int32) - contributed
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), is_eob[:-1]])
    base = _cummax(torch.where(seg_start, excl, 0))
    coeff_pos = excl - base

    # values land at min(coeff_pos, block_size - 1), a negative column
    # counting from the end (NumPy indexing, as the JAX scatter does); the
    # rest, and blocks past num_blocks, go to the trash slot
    col = coeff_pos.clamp(max=block_size - 1)
    col = torch.where(col < 0, col + block_size, col)
    keep = is_value & (block_id < num_blocks) & (col >= 0)
    flat = torch.where(keep, block_id * block_size + col, num_blocks * block_size)
    out = torch.zeros(num_blocks * block_size + 1, dtype=torch.int32, device=dev)
    out[flat] = s
    out = out[: num_blocks * block_size].reshape(num_blocks, block_size)

    num_eob = is_eob.sum()
    no_overflow = torch.where(valid, coeff_pos + contributed <= block_size, True).all()
    ok = (num_eob == num_blocks) & no_overflow
    return out, ok


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, dtype=np.int32, copy=True))


class ZeroRunCoder:
    """The course reference's zero-run coder facade.

    ``encode`` takes ``[H_patch, W_patch, C, block_size]`` coefficients and
    returns the compact int32 symbol stream (numpy); ``decode`` inverts it
    given the block-grid shape and returns a tensor on the stream's device.
    """

    def __init__(self, end_of_block: int = DEFAULT_EOB, block_size: int = 64):
        self.EOB = int(end_of_block)
        self.block_size = int(block_size)

    def encode(self, flat_patch_img) -> np.ndarray:
        blocks = _as_tensor(flat_patch_img).to(torch.int32).reshape(-1, self.block_size)
        buf, valid_len = zerorun_encode_blocks(blocks, self.block_size, self.EOB)
        stream, total = compact_symbols(buf, valid_len)
        return stream[: int(total)].cpu().numpy()

    def decode(self, encoded, original_shape) -> torch.Tensor:
        h, w, c = (int(v) for v in original_shape)
        s = _as_tensor(encoded).to(torch.int32)
        out, ok = zerorun_decode_stream(s, s.shape[0], h * w * c, self.block_size, self.EOB)
        if not bool(ok):
            raise ValueError("zero-run decode failed: corrupt stream or wrong shape")
        return out.reshape(h, w, c, self.block_size)
