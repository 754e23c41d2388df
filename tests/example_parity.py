"""Run a JAX chapter example and its twin in the port, and compare them.

Each JAX example under ``examples/`` is loaded by path (nothing there
changes) and its ``main()`` run on the CPU with stdout captured; the port's
twin ``ivclab_tpu_torch.examples.<name>.main(["--device", "cpu", ...])``
runs on the same arguments. ``ivclab_tpu_torch/examples/lines.py`` holds
the comparison and states each number's tolerance.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import sys
from pathlib import Path
from unittest import mock

from ivclab_tpu_torch.examples.lines import mismatches

REPO = Path(__file__).resolve().parents[1]


def capture(fn) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def jax_lines(name: str, argv: list[str]) -> list[str]:
    """The output of ``examples/<name>.py`` run with ``argv``, in process."""
    spec = importlib.util.spec_from_file_location(f"jax_examples_{name}",
                                                  REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with mock.patch.object(sys, "argv", [f"{name}.py", *argv]):
        return capture(module.main)


def assert_same_lines(name: str, jax: list[str], port: list[str]) -> None:
    problems = mismatches(name, jax, port)
    assert not problems, "\n".join(problems)


def check_example(module, argv: list[str]) -> None:
    """Run the JAX example and the port's twin on ``argv``; compare."""
    name = module.__name__.rsplit(".", 1)[1]
    port = capture(lambda: module.main(["--device", "cpu", *argv]))
    assert_same_lines(name, jax_lines(name, argv), port)

