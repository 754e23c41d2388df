"""Runtime validation (the sanitizer's counterpart).

Port of ``ivclab_tpu/runtime/debug.py``. The JAX package needs
``checkify`` because a data-dependent raise cannot live inside ``jit``;
PyTorch runs eagerly, so here the checks are explicit and run where they
are called:

- :func:`assert_finite` and :func:`assert_in_range` raise
  :class:`CheckError` (a ``ValueError``, as checkify's ``JaxRuntimeError``
  is) with the JAX package's message, under :func:`checked` or not. An
  eager JAX call of either check outside ``checked`` raises the same way,
  with the same text.
- :func:`checked` keeps the JAX wrapper's shape: it calls ``fn`` and
  returns its output, the checks inside having raised already.
- :func:`debug_mode` is the counterpart of ``jax_debug_nans`` and
  ``jax_debug_infs``: every floating-point result of a PyTorch operation
  inside it is checked, and a NaN or an inf raises ``FloatingPointError``.

Each check reads a flag back from the tensor's device, which synchronises
a CUDA stream: they are for debugging, not for the hot path.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class CheckError(ValueError):
    """A failed :func:`assert_finite` or :func:`assert_in_range`."""


def _fail(message: str):
    raise CheckError(f"{message} (`check` failed)")


def checked(fn, errors=None):
    """Wrap ``fn`` as the JAX package does; its checks raise on their own
    (``errors``, the checkify error set there, has nothing to select)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs)

    return wrapper


def assert_finite(x, name: str = "tensor"):
    """Raise :class:`CheckError` if ``x`` holds a NaN or an inf; return ``x``."""
    if not bool(torch.isfinite(torch.as_tensor(x)).all()):
        _fail(f"non-finite values in {name}")
    return x


def assert_in_range(x, lo, hi, name: str = "tensor"):
    """Raise :class:`CheckError` unless every value lies in ``[lo, hi)``
    (the Huffman alphabet-range check); return ``x``."""
    t = torch.as_tensor(x)
    if not bool(((t >= lo) & (t < hi)).all()):
        _fail(f"{name} outside [{lo}, {hi})")
    return x


class _FloatCheckMode(TorchDispatchMode):
    """Checks every floating-point tensor an operation returns."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans = nans
        self.infs = infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"inf in the output of {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """Raise ``FloatingPointError`` on a NaN (``nans``) or an inf (``infs``)
    in any floating-point result inside the region; the previous state (an
    enclosing ``debug_mode`` or none) holds again on exit."""
    with _FloatCheckMode(nans, infs):
        yield
