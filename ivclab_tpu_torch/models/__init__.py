"""Codecs built from the ops."""

from ivclab_tpu_torch.entropy.huffman import HuffmanCoder
from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec
from ivclab_tpu_torch.models.intracodec import IntraCodec, IntraCodecAdaptive
from ivclab_tpu_torch.models.videocodec import VideoCodec
from ivclab_tpu_torch.ops.motion import MotionCompensator
from ivclab_tpu_torch.utils.metrics import calc_psnr

__all__ = [
    "FusedVideoCodec", "HuffmanCoder", "IntraCodec", "IntraCodecAdaptive", "MotionCompensator",
    "VideoCodec", "calc_psnr",
]
