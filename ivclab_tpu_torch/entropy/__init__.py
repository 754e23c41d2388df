"""Entropy coding and statistics: histograms and pmfs, canonical and
hot/escape codes, ``HuffmanCoder`` and the headless plots."""

from ivclab_tpu_torch.entropy.stats import (
    stats_marg,
    smooth_pmf,
    calc_entropy,
    min_code_length,
    stats_joint,
    stats_cond,
    basic_histo,
    count_rgb_histogram,
    histogram_int32,
)
from ivclab_tpu_torch.entropy.codebook import (
    CanonicalCode,
    build_canonical_code,
    canonical_from_lengths,
    huffman_code_lengths,
    limit_code_lengths,
)
from ivclab_tpu_torch.entropy.huffman import HuffmanCoder
from ivclab_tpu_torch.entropy.plots import plot_histogram, plot_image_and_joint_histogram
from ivclab_tpu_torch.ops.zerorun import ZeroRunCoder

__all__ = [
    "stats_marg", "smooth_pmf", "calc_entropy", "min_code_length",
    "stats_joint", "stats_cond", "basic_histo", "count_rgb_histogram",
    "histogram_int32",
    "CanonicalCode", "build_canonical_code", "canonical_from_lengths",
    "huffman_code_lengths", "limit_code_lengths",
    "HuffmanCoder", "ZeroRunCoder",
    "plot_histogram", "plot_image_and_joint_histogram",
]
