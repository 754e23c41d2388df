"""The port's ch1 chapter example against the JAX package's, line by line,
five-image method comparison included (``ivclab_tpu_torch/examples/lines.py``
states the rules)."""

from __future__ import annotations

import torch_parity  # noqa: F401  (one torch thread; the JAX engine prebuilt)
from example_parity import check_example

from ivclab_tpu_torch.examples import ch1_basics


def test_example_prints_the_jax_lines():
    check_example(ch1_basics, [])
