"""The port's ch3 and ch4 chapter examples against the JAX package's, line
by line (``ivclab_tpu_torch/examples/lines.py`` states the rules), and the
comparison's own checks. ch1 and ch2 are in ``test_torch_examples_ch1.py`` and
``test_torch_examples_ch2.py``, each file inside its time budget.
"""

from __future__ import annotations

import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread; the JAX engine prebuilt)
from example_parity import assert_same_lines, check_example

from ivclab_tpu_torch.examples import ch1_basics, ch2_entropy, ch3_intra, ch4_video


@pytest.mark.parametrize("module,argv", [
    pytest.param(ch3_intra, [], id="ch3_intra"),
    pytest.param(ch4_video, ["--quick", "--frames", "3"], id="ch4_video"),
])
def test_example_prints_the_jax_lines(module, argv):
    check_example(module, argv)


def test_rules_catch_a_changed_number():
    """The comparison passes numbers inside their rules and fails a line
    whose number moved past its rule or whose words changed."""
    base = ["q=0.15 : bpp=4.5107  PSNR=38.93 dB", "keep 64/64 coefficients: PSNR = 145.82 dB"]
    assert_same_lines("ch3_intra", base, ["q=0.15 : bpp=4.5107  PSNR=38.94 dB",
                                          "keep 64/64 coefficients: PSNR = 143.23 dB"])
    for bad in (["q=0.15 : bpp=4.5108  PSNR=38.93 dB", base[1]],
                ["q=0.15 : bpp=4.5107  PSNR=38.96 dB", base[1]],
                [base[0], "keep 64/64 coefficients: PSNR = 99.00 dB"],
                [base[0].replace("bpp", "bits"), base[1]],
                base[:1]):
        with pytest.raises(AssertionError):
            assert_same_lines("ch3_intra", base, bad)


def test_examples_default_to_the_card():
    """Each twin's ``--device`` defaults to ``cuda``: without a card the
    first tensor placed there raises, before a line of results."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for module, argv in ((ch1_basics, []), (ch2_entropy, []), (ch3_intra, []),
                         (ch4_video, ["--quick", "--frames", "2"])):
        with pytest.raises((AssertionError, RuntimeError)):
            module.main(argv)
