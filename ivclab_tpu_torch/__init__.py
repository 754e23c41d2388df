"""ivclab_tpu_torch: the PyTorch + CUDA port of ivclab_tpu.

The package mirrors ``ivclab_tpu``'s layout (``ops``, ``entropy``,
``models``, ``runtime``, ``utils``) so each module's twin sits under the
same path, and exports the same public names at the top. It imports
PyTorch and numpy only (PIL and matplotlib inside the image I/O and plot
functions); the CUDA kernels under ``csrc/`` are compiled at first use on
a CUDA tensor, and the C++ entropy engine at its first use, never at
import.
"""

from ivclab_tpu_torch.version import __version__

# L0 utilities
from ivclab_tpu_torch.utils import (
    imread,
    imwrite,
    imshow,
    calc_mse,
    calc_psnr,
    ZigZag,
    Patcher,
)

# L1 signal processing
from ivclab_tpu_torch.ops import (
    rgb2gray,
    rgb2ycbcr,
    rgb2ycbcr_ict,
    ycbcr2rgb,
    ycbcr2rgb_ict,
    DiscreteCosineTransform,
    zigzag_scan,
    downsample,
    upsample,
    interpolation_upsample,
    lowpass_filter,
    FilterPipeline,
)

# L2 entropy / statistics
from ivclab_tpu_torch.entropy import (
    stats_marg,
    smooth_pmf,
    calc_entropy,
    min_code_length,
    stats_joint,
    stats_cond,
    HuffmanCoder,
    ZeroRunCoder,
)

# L2b quantization
from ivclab_tpu_torch.ops.quant import PatchQuant

# L3 image codecs
from ivclab_tpu_torch.models import (
    IntraCodec,
    IntraCodecAdaptive,
    PredictiveCodec,
    ict_compression,
    min_entropy_predictor,
    single_pixel_predictor,
    three_pixels_predictor,
    yuv420compression,
)

# L4 video codecs
from ivclab_tpu_torch.models import FusedVideoCodec, MotionCompensator, VideoCodec

__all__ = [
    "__version__",
    "imread", "imwrite", "imshow", "calc_mse", "calc_psnr", "ZigZag", "Patcher",
    "rgb2gray", "rgb2ycbcr", "rgb2ycbcr_ict", "ycbcr2rgb", "ycbcr2rgb_ict", "DiscreteCosineTransform",
    "zigzag_scan", "downsample", "upsample", "interpolation_upsample",
    "lowpass_filter", "FilterPipeline",
    "stats_marg", "smooth_pmf", "calc_entropy", "min_code_length",
    "stats_joint", "stats_cond", "HuffmanCoder", "ZeroRunCoder",
    "PatchQuant",
    "IntraCodec", "IntraCodecAdaptive", "PredictiveCodec", "ict_compression",
    "min_entropy_predictor", "single_pixel_predictor", "three_pixels_predictor",
    "yuv420compression",
    "FusedVideoCodec", "MotionCompensator", "VideoCodec",
]
