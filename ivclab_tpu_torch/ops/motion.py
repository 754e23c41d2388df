"""Block motion estimation / compensation.

Port of ``ivclab_tpu/ops/motion.py``. Full-search block matching returns,
for each 8x8 block of the current frame, the packed index
``(dy + sr) * (2 sr + 1) + (dx + sr)`` of the displaced reference block
with the smallest SSD. Candidates that fall outside the frame are masked
to +inf, and the argmin takes the first candidate in scan order (dy outer,
dx inner) on a tie.

``motion_search`` dispatches on the device of its inputs: a CPU tensor
goes to the plain PyTorch version, a CUDA tensor to the hand-written
Hopper kernel ``csrc/motion_search.cu`` (or the call raises).
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Kernel launches made by ``motion_search_cuda`` in this process.
LAUNCHES = 0

BLOCK = 8  # block size of the search, the kernel and the codec


def motion_search_reference(ref_image: torch.Tensor, image: torch.Tensor,
                            search_range: int = 4) -> torch.Tensor:
    """Plain PyTorch full search: one rolled frame per candidate.

    ref_image, image: ``[H, W]`` float32 (H, W multiples of 8).
    Returns ``[H/8, W/8]`` int32 packed indices.
    """
    sr = search_range
    block = BLOCK
    ref = ref_image.to(torch.float32)
    cur = image.to(torch.float32)
    H, W = cur.shape
    hb, wb = H // block, W // block
    dev = cur.device
    by = torch.arange(hb, dtype=torch.int32, device=dev) * block
    bx = torch.arange(wb, dtype=torch.int32, device=dev) * block

    min_ssd = torch.full((hb, wb), float("inf"), dtype=torch.float32, device=dev)
    best = torch.zeros((hb, wb), dtype=torch.int32, device=dev)
    for dy in range(-sr, sr + 1):
        for dx in range(-sr, sr + 1):
            shifted = torch.roll(ref, shifts=(-dy, -dx), dims=(0, 1))
            diff = cur - shifted
            ssd = (diff * diff).reshape(hb, block, wb, block).sum(dim=(1, 3))
            valid_y = (by + dy >= 0) & (by + dy + block <= H)
            valid_x = (bx + dx >= 0) & (bx + dx + block <= W)
            ssd = ssd.masked_fill(~(valid_y[:, None] & valid_x[None, :]), float("inf"))
            idx = (dy + sr) * (2 * sr + 1) + (dx + sr)
            take = ssd < min_ssd  # strict: first candidate in scan order wins ties
            min_ssd = torch.where(take, ssd, min_ssd)
            best = best.masked_fill(take, idx)
    return best


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from ivclab_tpu_torch.runtime import cuda_build

    fn = cuda_build.load("motion_search").ivc_motion_search
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def motion_search_cuda(ref_image: torch.Tensor, image: torch.Tensor,
                       search_range: int = 4) -> torch.Tensor:
    """Launch the Hopper kernel (``csrc/motion_search.cu``) on one frame pair.

    Takes contiguous float32 ``[H, W]`` CUDA tensors on one device, H and W
    multiples of 8, ``1 <= search_range <= 7``; raises on anything else and
    on a launch error. Runs on the current stream without synchronising.
    """
    global LAUNCHES
    for name, t in (("ref_image", ref_image), ("image", image)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if ref_image.shape != image.shape:
        raise ValueError("ref_image and image must have the same shape")
    H, W = image.shape
    if H == 0 or W == 0 or H % 8 or W % 8:
        raise ValueError(f"frame {H}x{W} is not a nonzero multiple of 8")
    sr = int(search_range)
    if not 1 <= sr <= 7:
        raise ValueError(f"search_range {sr} outside [1, 7]")
    if not (image.is_cuda and ref_image.device == image.device):
        raise ValueError(f"needs both frames on one CUDA device, got "
                         f"{ref_image.device} and {image.device}")
    out = torch.empty((H // 8, W // 8), dtype=torch.int32, device=image.device)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    rc = _kernel_fn()(ref_image.data_ptr(), image.data_ptr(), out.data_ptr(),
                      H, W, sr, 0, H, stream)
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


def motion_compensate(ref_image: torch.Tensor, motion_idx: torch.Tensor,
                      search_range: int = 4) -> torch.Tensor:
    """Displace the 8x8 tiles of the ``[H, W]`` plane ``ref_image`` by the
    ``[H/8, W/8]`` packed motion field.

    Per-pixel source coordinates come from each block's displacement,
    clipped to the frame. For the in-frame fields the encoder emits this
    equals the JAX package's select-based ``motion_compensate_dense`` bit
    for bit.
    """
    sr = search_range
    block = BLOCK
    ref = ref_image.to(torch.float32)
    H, W = ref.shape
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
