"""Fixtures of the benchmark's own tests (run them with
``python3 -m pytest codec_bench/tests -q``)."""

import pytest
import torch

# tiny CPU windows: one intra-op thread a test process, so that parallel
# test workers do not slow each other's windows below the GOPs they check
torch.set_num_threads(1)


@pytest.fixture
def tiny(tmp_path):
    """A tiny copy of the benchmark: its manifest's path."""
    from codec_bench.tests.tiny import tiny_root

    return tiny_root(tmp_path)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
