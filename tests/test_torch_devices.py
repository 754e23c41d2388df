"""The port's entry points run on the card unless the caller asks for the CPU.

Each public entry point that places tensors defaults to ``device="cuda"``;
on a machine without a card such a call raises from torch the first time
it puts a tensor on the device, and nothing carries on on the CPU.
"""

import inspect

import numpy as np
import pytest
import torch

from ivclab_tpu_torch import FusedVideoCodec, IntraCodec, IntraCodecAdaptive
from ivclab_tpu_torch.ops import bitpack
from ivclab_tpu_torch.parallel import make_mesh
from ivclab_tpu_torch.runtime import container

ENTRY_POINTS = {
    "FusedVideoCodec.__init__": FusedVideoCodec.__init__,
    "FusedVideoCodec.from_reference_state": FusedVideoCodec.from_reference_state,
    "FusedVideoCodec.decode_from_container": FusedVideoCodec.decode_from_container,
    "IntraCodec.__init__": IntraCodec.__init__,
    "IntraCodec.from_reference_state": IntraCodec.from_reference_state,
    "IntraCodec.decode_from_container": IntraCodec.decode_from_container,
    "parallel.make_mesh": make_mesh,
    "IntraCodecAdaptive.__init__": IntraCodecAdaptive.__init__,
    "ops.bitpack.decode_tables": bitpack.decode_tables,
    "runtime.container.GroupedSection.device_views": container.GroupedSection.device_views,
    "runtime.container.device_views": container.device_views,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    default = inspect.signature(ENTRY_POINTS[name]).parameters["device"].default
    assert default == "cuda", f"{name} defaults to {default!r}"


def test_default_codecs_refuse_to_run_without_a_card():
    """Without a card the default codecs raise from torch; they never fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    with pytest.raises((RuntimeError, AssertionError)):
        FusedVideoCodec(1.0)
    codec = IntraCodec(0.5)
    assert codec.device.type == "cuda"
    img = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises((RuntimeError, AssertionError)):
        codec.train_huffman_from_image(img)
    assert codec.huffman is None


def test_make_mesh_defaults_to_the_card():
    mesh = make_mesh(1, 2)
    assert mesh.device == torch.device("cuda")
    assert make_mesh(1, 2, device="cpu").device == torch.device("cpu")
