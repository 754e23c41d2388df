"""Orthonormal 8x8 DCT-II / DCT-III on flattened blocks.

Port of ``ivclab_tpu/ops/dct.py``. Blocks are ``[N, 64]`` row-major vectors
transformed by one ``[64, 64]`` float32 matrix product with
``kron(D, D)``; the JPEG zig-zag permutation is folded into the matrix
rows, so coefficients come out in scan order.

The product is a plain ``torch.matmul`` in full float32. TF32 would change
the coefficients, and with them the quantized symbols near a rounding
boundary, so :func:`require_full_fp32` turns it off and checks it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ivclab_tpu_torch.utils.shape import zigzag_gather_indices


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int = 8) -> np.ndarray:
    """Orthonormal DCT-II matrix ``D`` with ``y = D @ x`` (float64).

    ``D[k, m] = s_k * cos(pi * (2m + 1) * k / (2n))``,
    ``s_0 = sqrt(1/n)``, ``s_k = sqrt(2/n)``.
    """
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    D = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    D *= np.sqrt(2.0 / n)
    D[0] *= np.sqrt(0.5)
    D.setflags(write=False)
    return D


@functools.lru_cache(maxsize=None)
def dct2_kron_matrix(n: int = 8, zigzag: bool = True, inverse: bool = False) -> np.ndarray:
    """``[n*n, n*n]`` matrix applying the 2-D DCT to row-major flattened blocks.

    Forward: ``y_flat = K @ x_flat`` equals ``vec(D @ X @ D.T)``; with
    ``zigzag`` the rows are permuted so ``y`` is in JPEG scan order.
    Inverse maps (optionally scan-ordered) coefficients back to pixels.
    """
    D = dct_matrix(n)
    K = np.kron(D, D)
    if inverse:
        K = K.T  # orthonormal
        if zigzag:
            K = K[:, zigzag_gather_indices(n)]
    elif zigzag:
        K = K[zigzag_gather_indices(n), :]
    K = np.ascontiguousarray(K)
    K.setflags(write=False)
    return K


def require_full_fp32() -> None:
    """Turn TF32 off for CUDA matmuls and convolutions, and check it stuck."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is still enabled; the codec needs full float32")


@functools.lru_cache(maxsize=None)
def _kron_t(inverse: bool, device: torch.device) -> torch.Tensor:
    K = dct2_kron_matrix(8, zigzag=True, inverse=inverse)
    return torch.tensor(K.T, dtype=torch.float32, device=device)


def dct2_fused(flat_blocks: torch.Tensor) -> torch.Tensor:
    """Forward transform: ``[N, 64]`` row-major blocks -> scan-ordered coefficients."""
    x = flat_blocks.to(torch.float32)
    return torch.matmul(x, _kron_t(False, x.device))


def idct2_fused(flat_coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse transform: scan-ordered ``[N, 64]`` coefficients -> pixels."""
    x = flat_coeffs.to(torch.float32)
    return torch.matmul(x, _kron_t(True, x.device))
