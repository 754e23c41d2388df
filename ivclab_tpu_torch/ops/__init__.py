"""Tensor operations (PyTorch): colour, transforms, quantization,
resampling and filtering, zero-run coding, motion and the DPCM wavefront."""

from ivclab_tpu_torch.ops.color import rgb2gray, rgb2ycbcr, rgb2ycbcr_ict, ycbcr2rgb, ycbcr2rgb_ict
from ivclab_tpu_torch.ops.dct import (
    DiscreteCosineTransform,
    dct_matrix,
    dct2,
    idct2,
    dct2_fused,
    idct2_fused,
    zigzag_scan,
)
from ivclab_tpu_torch.ops.quant import (
    PatchQuant,
    quant_tables,
    quant_table_zigzag,
    quantize_flat,
    dequantize_flat,
)
from ivclab_tpu_torch.ops.resample import (
    downsample,
    upsample,
    interpolation_upsample,
    lowpass_filter,
    decimate,
    fft_resample,
    resample,
    FilterPipeline,
)
from ivclab_tpu_torch.ops.zerorun import (
    ZeroRunCoder,
    zerorun_encode_blocks,
    zerorun_decode_stream,
    compact_symbols,
)

__all__ = [
    "rgb2gray", "rgb2ycbcr", "rgb2ycbcr_ict", "ycbcr2rgb", "ycbcr2rgb_ict",
    "DiscreteCosineTransform", "dct_matrix", "dct2", "idct2",
    "dct2_fused", "idct2_fused", "zigzag_scan",
    "PatchQuant", "quant_tables", "quant_table_zigzag",
    "quantize_flat", "dequantize_flat",
    "downsample", "upsample", "interpolation_upsample", "lowpass_filter",
    "decimate", "fft_resample", "resample", "FilterPipeline",
    "ZeroRunCoder", "zerorun_encode_blocks", "zerorun_decode_stream",
    "compact_symbols",
]
