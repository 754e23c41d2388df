"""ivclab_tpu_torch: the PyTorch + CUDA port of ivclab_tpu.

The package mirrors ``ivclab_tpu``'s layout (``ops``, ``entropy``,
``models``, ``runtime``, ``utils``) so each module's twin sits under the
same path. It imports PyTorch and numpy only; the CUDA kernels under
``csrc/`` are compiled at first use on a CUDA tensor, never at import.
"""

from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec

__version__ = "0.1.0"

__all__ = ["FusedVideoCodec", "__version__"]
