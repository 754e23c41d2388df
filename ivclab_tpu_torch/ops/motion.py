"""Block motion estimation / compensation.

Port of ``ivclab_tpu/ops/motion.py`` (with its ``MotionCompensator``
facade) and of the band search of ``ivclab_tpu/parallel/halo.py``.
Full-search block matching returns, for
each 8x8 block of the current frame, the packed index
``(dy + sr) * (2 sr + 1) + (dx + sr)`` of the displaced reference block
with the smallest SSD. Candidates that fall outside the frame are masked
to +inf, and the argmin takes the first candidate in scan order (dy outer,
dx inner) on a tie.

The band search (``motion_search_tile``) does the same for one row band of
a taller frame: the reference band arrives with ``sr`` halo rows above and
below, and row validity comes from the band's first frame row and the
frame height.

``motion_search`` and ``motion_search_tile`` dispatch on the device of
their inputs: CPU tensors go to the plain PyTorch version, CUDA tensors to
the hand-written Hopper kernel ``csrc/motion_search.cu`` (or the call
raises).

``motion_search_kernel_order`` and ``motion_search_tile_kernel_order``
repeat the kernel's arithmetic step for step (each SSD summed from 0 in
row-then-column order, every subtract, square and add rounded on its own),
so the kernel must equal them bit for bit on any finite input. They serve
the tests and ``chip_smoke.py``; no codec path calls them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

# Kernel launches made in this process by ``motion_search_cuda`` (whole
# frames) and by ``motion_search_tile_cuda`` (row bands).
LAUNCHES = 0
TILE_LAUNCHES = 0

BLOCK = 8  # block size of the search, the kernel and the codec
MAX_SEARCH_RANGE = 15  # the kernel is instantiated for search ranges 1..15


def motion_search_tile_reference(ref_ext: torch.Tensor, cur_tile: torch.Tensor, row0: int,
                                 total_h: int, search_range: int = 4) -> torch.Tensor:
    """Plain PyTorch band search: one row slice and column roll per candidate.

    ref_ext: ``[Ht + 2 sr, W]`` reference band with its halo rows;
    cur_tile: ``[Ht, W]`` current band; row0: frame row of the band's first
    row; total_h: frame height. Returns ``[Ht/8, W/8]`` int32 packed indices.
    """
    sr = search_range
    block = BLOCK
    ref = ref_ext.to(torch.float32)
    cur = cur_tile.to(torch.float32)
    Ht, W = cur.shape
    hb, wb = Ht // block, W // block
    dev = cur.device
    by = torch.arange(hb, dtype=torch.int32, device=dev) * block + int(row0)
    bx = torch.arange(wb, dtype=torch.int32, device=dev) * block

    min_ssd = torch.full((hb, wb), float("inf"), dtype=torch.float32, device=dev)
    best = torch.zeros((hb, wb), dtype=torch.int32, device=dev)
    for dy in range(-sr, sr + 1):
        rows = ref[sr + dy:sr + dy + Ht]  # candidate rows sit at offset sr + dy
        for dx in range(-sr, sr + 1):
            shifted = torch.roll(rows, shifts=-dx, dims=1)
            diff = cur - shifted
            ssd = (diff * diff).reshape(hb, block, wb, block).sum(dim=(1, 3))
            valid_y = (by + dy >= 0) & (by + dy + block <= total_h)
            valid_x = (bx + dx >= 0) & (bx + dx + block <= W)
            ssd = ssd.masked_fill(~(valid_y[:, None] & valid_x[None, :]), float("inf"))
            idx = (dy + sr) * (2 * sr + 1) + (dx + sr)
            take = ssd < min_ssd  # strict: first candidate in scan order wins ties
            min_ssd = torch.where(take, ssd, min_ssd)
            best = best.masked_fill(take, idx)
    return best


def motion_search_reference(ref_image: torch.Tensor, image: torch.Tensor,
                            search_range: int = 4) -> torch.Tensor:
    """Plain PyTorch full search over one frame.

    ref_image, image: ``[H, W]`` float32 (H, W multiples of 8).
    Returns ``[H/8, W/8]`` int32 packed indices. A whole frame is the band
    at row 0 whose halo rows lie outside the frame, so every candidate
    that reads them is masked.
    """
    sr = search_range
    ref = torch.nn.functional.pad(ref_image.to(torch.float32), (0, 0, sr, sr))
    return motion_search_tile_reference(ref, image, 0, image.shape[0], sr)


def motion_search_tile_kernel_order(ref_ext: torch.Tensor, cur_tile: torch.Tensor, row0: int,
                                    total_h: int, search_range: int = 4) -> torch.Tensor:
    """Band search in the kernel's arithmetic: for each candidate a float32
    accumulator from 0 takes ``(c - r) * (c - r)`` pixel by pixel, rows
    outer and columns inner, each subtract, multiply and add a separate
    elementwise op; out-of-frame candidates are masked and the argmin is
    the strict ``<`` first in scan order. Same arguments and result as
    :func:`motion_search_tile_reference`.
    """
    sr = search_range
    block = BLOCK
    total = 2 * sr + 1
    cur = cur_tile.to(torch.float32)
    Ht, W = cur.shape
    hb, wb = Ht // block, W // block
    dev = cur.device
    # columns padded by sr zeros: candidate dx reads columns sr + dx onward
    ref = torch.nn.functional.pad(ref_ext.to(torch.float32), (sr, sr))
    cur_px = cur.reshape(hb, block, wb, block)
    by = torch.arange(hb, device=dev) * block + int(row0)
    bx = torch.arange(wb, device=dev) * block

    min_ssd = torch.full((hb, wb), float("inf"), dtype=torch.float32, device=dev)
    best = torch.zeros((hb, wb), dtype=torch.int32, device=dev)
    for dy in range(-sr, sr + 1):
        rows = ref[sr + dy:sr + dy + Ht]
        # [total, hb, 8, wb, 8]: every dx of this dy
        cand = torch.stack([rows[:, sr + dx:sr + dx + W] for dx in range(-sr, sr + 1)])
        cand = cand.reshape(total, hb, block, wb, block)
        acc = torch.zeros((total, hb, wb), dtype=torch.float32, device=dev)
        for r in range(block):
            for k in range(block):
                diff = cur_px[:, r, :, k] - cand[:, :, r, :, k]
                acc = acc + diff * diff
        valid_y = (by + dy >= 0) & (by + dy + block <= total_h)
        for d in range(total):
            dx = d - sr
            valid_x = (bx + dx >= 0) & (bx + dx + block <= W)
            take = valid_y[:, None] & valid_x[None, :] & (acc[d] < min_ssd)
            min_ssd = torch.where(take, acc[d], min_ssd)
            best = best.masked_fill(take, (dy + sr) * total + d)
    return best


def motion_search_kernel_order(ref_image: torch.Tensor, image: torch.Tensor,
                               search_range: int = 4) -> torch.Tensor:
    """Whole-frame search in the kernel's arithmetic: the band at row 0 of a
    frame whose halo rows lie outside it (see
    :func:`motion_search_tile_kernel_order`)."""
    sr = search_range
    ref = torch.nn.functional.pad(ref_image.to(torch.float32), (0, 0, sr, sr))
    return motion_search_tile_kernel_order(ref, image, 0, image.shape[0], sr)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a ``csrc/motion_search.cu`` build on ``lib``."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ivc_motion_search.argtypes = [vp, vp, vp, i, i, i, vp]
    lib.ivc_motion_search.restype = i
    lib.ivc_motion_search_tile.argtypes = [vp, i, vp, vp, i, i, i, i, i, vp]
    lib.ivc_motion_search_tile.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    from ivclab_tpu_torch.runtime import cuda_build

    return bind(cuda_build.load("motion_search"))


def _check_planes(device, **planes: torch.Tensor):
    for name, t in planes.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
        if not (t.is_cuda and t.device == device):
            raise ValueError(f"needs every plane on one CUDA device, got {name} on {t.device}")
        if t.data_ptr() % 16:  # the copy engine's tensor maps need 16-byte aligned planes
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_search_range(search_range) -> int:
    sr = int(search_range)
    if not 1 <= sr <= MAX_SEARCH_RANGE:
        raise ValueError(f"search_range {sr} outside [1, {MAX_SEARCH_RANGE}]: the CUDA kernel "
                         f"is built for search ranges up to {MAX_SEARCH_RANGE}")
    return sr


def motion_search_cuda(ref_image: torch.Tensor, image: torch.Tensor,
                       search_range: int = 4) -> torch.Tensor:
    """Launch the Hopper kernel (``csrc/motion_search.cu``) on one frame pair.

    Takes contiguous float32 ``[H, W]`` CUDA tensors on one device, H and W
    multiples of 8, ``1 <= search_range <= 15``; raises on anything else and
    on a launch error. Runs on the current stream without synchronising.
    """
    global LAUNCHES
    if ref_image.shape != image.shape:
        raise ValueError("ref_image and image must have the same shape")
    H, W = image.shape
    if H == 0 or W == 0 or H % 8 or W % 8:
        raise ValueError(f"frame {H}x{W} is not a nonzero multiple of 8")
    sr = _check_search_range(search_range)
    _check_planes(image.device, ref_image=ref_image, image=image)
    out = torch.empty((H // 8, W // 8), dtype=torch.int32, device=image.device)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    rc = _lib().ivc_motion_search(ref_image.data_ptr(), image.data_ptr(), out.data_ptr(),
                                  H, W, sr, stream)
    if rc != 0:
        raise RuntimeError(f"motion_search kernel launch failed (cudaError {rc})")
    LAUNCHES += 1
    return out


def motion_search(ref_image: torch.Tensor, image: torch.Tensor,
                  search_range: int = 4) -> torch.Tensor:
    """Full-search block matching -> ``[H/8, W/8]`` int32 indices.

    CPU tensors run :func:`motion_search_reference`; CUDA tensors run the
    kernel through :func:`motion_search_cuda`.
    """
    if image.is_cuda or ref_image.is_cuda:
        return motion_search_cuda(ref_image, image, search_range)
    return motion_search_reference(ref_image, image, search_range)


def motion_search_tile_cuda(ref_ext: torch.Tensor, cur_tile: torch.Tensor, row0: int,
                            total_h: int, search_range: int = 4) -> torch.Tensor:
    """Launch the Hopper kernel's band entry point on one halo-extended band.

    Takes contiguous float32 CUDA tensors on one device: ``ref_ext``
    ``[Ht + 2 sr, W]`` and ``cur_tile`` ``[Ht, W]``. The kernel's entry
    point checks the rest (Ht and W multiples of 8, ``ref_ext``'s row
    count, ``row0 >= 0``, ``row0 % 8 == 0``, ``row0 + Ht <= total_h``) and
    returns an error code, on which this raises, as on a launch error. Runs
    on the current stream without synchronising.
    """
    global TILE_LAUNCHES
    sr = _check_search_range(search_range)
    _check_planes(cur_tile.device, ref_ext=ref_ext, cur_tile=cur_tile)
    if ref_ext.shape[1] != cur_tile.shape[1]:
        raise ValueError("ref_ext and cur_tile must have the same width")
    Ht, W = cur_tile.shape
    out = torch.empty((Ht // 8, W // 8), dtype=torch.int32, device=cur_tile.device)
    stream = torch.cuda.current_stream(cur_tile.device).cuda_stream
    rc = _lib().ivc_motion_search_tile(ref_ext.data_ptr(), ref_ext.shape[0], cur_tile.data_ptr(),
                                       out.data_ptr(), Ht, W, sr, int(row0), int(total_h), stream)
    if rc != 0:
        raise RuntimeError(f"motion_search_tile kernel refused or failed (cudaError {rc}): "
                           f"band {Ht}x{W} with {ref_ext.shape[0]} reference rows, "
                           f"row0={row0}, total_h={total_h}, sr={sr}")
    TILE_LAUNCHES += 1
    return out


def motion_search_tile(ref_ext: torch.Tensor, cur_tile: torch.Tensor, row0: int,
                       total_h: int, search_range: int = 4) -> torch.Tensor:
    """Band search -> ``[Ht/8, W/8]`` int32 indices, equal to the rows of the
    whole-frame search that the band covers.

    CPU tensors run :func:`motion_search_tile_reference`; CUDA tensors run
    the kernel through :func:`motion_search_tile_cuda`.
    """
    if cur_tile.is_cuda or ref_ext.is_cuda:
        return motion_search_tile_cuda(ref_ext, cur_tile, row0, total_h, search_range)
    return motion_search_tile_reference(ref_ext, cur_tile, row0, total_h, search_range)


def motion_compensate(ref_image: torch.Tensor, motion_idx: torch.Tensor,
                      search_range: int = 4) -> torch.Tensor:
    """Displace the 8x8 tiles of the ``[H, W]`` (or ``[H, W, C]``) image
    ``ref_image`` by the ``[H/8, W/8]`` packed motion field.

    Per-pixel source coordinates come from each block's displacement,
    clipped to the frame. For the in-frame fields the encoder emits this
    equals the JAX package's select-based ``motion_compensate_dense`` bit
    for bit.
    """
    sr = search_range
    block = BLOCK
    ref = ref_image.to(torch.float32)
    H, W = ref.shape[:2]
    total = 2 * sr + 1
    mv = motion_idx.to(device=ref.device, dtype=torch.int64)
    dy = torch.div(mv, total, rounding_mode="floor") - sr
    dx = torch.remainder(mv, total) - sr
    dy_pix = dy.repeat_interleave(block, 0).repeat_interleave(block, 1)
    dx_pix = dx.repeat_interleave(block, 0).repeat_interleave(block, 1)
    rows = torch.arange(H, device=ref.device)[:, None]
    cols = torch.arange(W, device=ref.device)[None, :]
    yy = (rows + dy_pix).clamp(0, H - 1)
    xx = (cols + dx_pix).clamp(0, W - 1)
    return ref[yy, xx]


class MotionCompensator:
    """The course reference's motion facade (packed-index convention).

    Takes and returns host numpy arrays, as the reference's class does; the
    search and the compensation run on ``device`` (the kernel on the card).
    """

    def __init__(self, search_range: int = 4, device: str | torch.device = "cuda"):
        self.search_range = int(search_range)
        self.device = torch.device(device)

    def _plane(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
        return t.to(device=self.device, dtype=torch.float32).contiguous()

    def compute_motion_vector(self, ref_image, image) -> np.ndarray:
        """``[H/8, W/8, 1]`` packed motion indices of ``image`` against
        ``ref_image`` (both ``[H, W]``)."""
        mv = motion_search(self._plane(ref_image), self._plane(image), self.search_range)
        return mv.cpu().numpy()[..., None].astype(int)

    def reconstruct_with_motion_vector(self, ref_image, motion_vector) -> np.ndarray:
        """Motion-compensated prediction from ``ref_image`` (``[H, W]`` or
        ``[H, W, C]``) and a ``[H/8, W/8, 1]`` field."""
        mv = torch.from_numpy(np.asarray(motion_vector)[..., 0].astype(np.int64))
        return motion_compensate(self._plane(ref_image), mv, self.search_range).cpu().numpy()
