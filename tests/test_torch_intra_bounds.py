"""The intra codec's codebook alphabet: ``train_huffman_from_image(...,
bounds=)`` and ``IntraCodec.full_bounds()``.

Trained over the training image's own range (the default, as the JAX
package trains), a symbol of another image outside that range is clamped
to the alphabet's edge by the pack and decodes to another symbol. Trained
over ``full_bounds()``, every symbol an image of 8-bit levels can produce
has a code: the extreme images below (each block the pattern that drives
one coefficient of one plane to its largest or smallest value) lie inside
the bounds, and a codebook trained on a dim image codes them exactly.
"""

import numpy as np
import pytest
import torch

from ivclab_tpu_torch.models.intracodec import IntraCodec, bucket_bounds
from ivclab_tpu_torch.ops.color import _RGB2YCBCR
from ivclab_tpu_torch.ops.dct import dct2_kron_matrix
from ivclab_tpu_torch.utils import fixtures

SWEEP = (0.05, 0.1, 0.15, 0.2, 0.3, 1.0)


def _extreme_image() -> np.ndarray:
    """``[8, 3072, 3]`` uint8 RGB: for each plane, scan position and sign,
    the 8x8 block whose every pixel is the corner of the RGB cube with the
    plane's largest value where the basis function is positive and its
    smallest where it is negative (or the reverse): the plane's
    coefficient at that position is as large (small) as 8-bit levels allow."""
    K = dct2_kron_matrix(8)  # scan-ordered rows over row-major pixels
    blocks = []
    for c in range(3):
        top = 255 * (_RGB2YCBCR[c] > 0)
        bottom = 255 * (_RGB2YCBCR[c] < 0)
        for k in range(64):
            for sign in (1, -1):
                up = (sign * K[k] > 0)[:, None]
                blocks.append(np.where(up, top, bottom).reshape(8, 8, 3))
    return np.concatenate(blocks, axis=1).astype(np.uint8)


def _photo(shape=(64, 128), scale: float = 1.0) -> np.ndarray:
    img = np.tile(fixtures.image("lena_small"), (2, 2, 1))[:shape[0], :shape[1]]
    return np.round(img * scale).astype(np.uint8)


@pytest.mark.parametrize("q", SWEEP)
def test_the_full_bounds_hold_every_symbol_of_the_extreme_images(q):
    codec = IntraCodec(q, device="cpu")
    lo, hi = codec.full_bounds()
    syms = codec.image2symbols(_extreme_image())
    assert lo <= int(syms.min()) and int(syms.max()) < hi
    # no looser than the training's own widening of the extreme range
    assert (lo, hi) == bucket_bounds(min(int(syms.min()), 0), max(int(syms.max()), 4000))


def test_explicit_bounds_equal_to_the_trained_ones_give_the_default_bytes():
    img = _photo()
    default = IntraCodec(0.15, device="cpu")
    default.train_huffman_from_image(img)
    given = IntraCodec(0.15, device="cpu")
    given.train_huffman_from_image(img, bounds=default.bounds)
    assert given.bounds == default.bounds
    assert given.encode_to_container(img) == default.encode_to_container(img)


def test_a_code_over_the_full_bounds_codes_an_image_it_was_not_trained_on():
    dim, bright = _photo(scale=0.25), _extreme_image()
    full = IntraCodec(0.15, device="cpu")
    full.train_huffman_from_image(dim, bounds=full.full_bounds())
    blob = full.encode_to_container(bright)
    assert IntraCodec.decode_from_container(blob, device="cpu").shape == bright.shape
    exact = full.symbols2image(full.image2symbols(bright), bright.shape)
    assert torch.equal(IntraCodec.decode_from_container(blob, device="cpu"), exact)
    assert full.huffman.code.lower_bound == full.full_bounds()[0]
    assert full.huffman.code.n == full.full_bounds()[1] - full.full_bounds()[0]
    # over the dim image's own range, the bright image's symbols are clamped
    own = IntraCodec(0.15, device="cpu")
    own.train_huffman_from_image(dim)
    syms = own.image2symbols(bright)
    assert int(syms.min()) < own.bounds[0]
    clamped = IntraCodec.decode_from_container(own.encode_to_container(bright), device="cpu")
    assert not torch.equal(clamped, exact)


def test_bounds_that_miss_a_training_symbol_are_refused():
    codec = IntraCodec(0.15, device="cpu")
    with pytest.raises(ValueError, match="outside the bounds"):
        codec.train_huffman_from_image(_extreme_image(), bounds=(-64, 4032))
    assert codec.huffman is None
