"""Codecs built from the ops."""

from ivclab_tpu_torch.entropy.huffman import HuffmanCoder
from ivclab_tpu_torch.models.intracodec import IntraCodec, IntraCodecAdaptive
from ivclab_tpu_torch.models.predictive import (
    min_entropy_predictor,
    single_pixel_predictor,
    three_pixels_predictor,
)
from ivclab_tpu_torch.models.yuv420 import ict_compression, yuv420compression, pad_image, crop_image
from ivclab_tpu_torch.models.dpcm import PredictiveCodec
from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec
from ivclab_tpu_torch.ops.motion import MotionCompensator
from ivclab_tpu_torch.models.videocodec import VideoCodec
from ivclab_tpu_torch.utils.metrics import calc_psnr

__all__ = [
    "IntraCodec", "IntraCodecAdaptive",
    "min_entropy_predictor", "single_pixel_predictor", "three_pixels_predictor",
    "yuv420compression", "ict_compression", "pad_image", "crop_image",
    "PredictiveCodec", "FusedVideoCodec", "MotionCompensator", "VideoCodec",
    "HuffmanCoder", "calc_psnr",
]
