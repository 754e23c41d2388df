"""ivclab_tpu_torch: the PyTorch + CUDA port of ivclab_tpu.

The package mirrors ``ivclab_tpu``'s layout (``ops``, ``entropy``,
``models``, ``runtime``, ``utils``) so each module's twin sits under the
same path. It imports PyTorch and numpy only; the CUDA kernels under
``csrc/`` are compiled at first use on a CUDA tensor, and the C++ entropy
engine at its first use, never at import.
"""

from ivclab_tpu_torch.entropy.huffman import HuffmanCoder
from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec
from ivclab_tpu_torch.models.intracodec import IntraCodec, IntraCodecAdaptive
from ivclab_tpu_torch.models.videocodec import VideoCodec
from ivclab_tpu_torch.ops.motion import MotionCompensator
from ivclab_tpu_torch.utils.metrics import calc_psnr

__version__ = "0.1.0"

__all__ = [
    "FusedVideoCodec",
    "HuffmanCoder",
    "IntraCodec",
    "IntraCodecAdaptive",
    "MotionCompensator",
    "VideoCodec",
    "calc_psnr",
    "__version__",
]
