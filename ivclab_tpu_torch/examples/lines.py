"""Compare two runs of a chapter example line by line.

The twins print the JAX examples' lines with the same format strings, so
two runs (JAX and the port, or the card and the CPU) are compared as text:
the same lines in the same order, equal once every number is blanked, and
each number within its rule (:data:`RULES`):

- integers (symbol, unique and stream-bit counts, ranges, q steps) and the
  ch3/ch4 bits per pixel: the same digits;
- PSNR: within 0.01 dB (the FFT lines too: ``torch.fft`` against
  ``jnp.fft`` moved them by at most 4e-5 dB), except ch3's ``keep 64/64``
  line, whose ~145 dB is the MSE of float32 noise and cannot match: above
  100 dB on both sides;
- ch2's DPCM bits per pixel within 0.003% (the subsampled chroma's FIR taps
  are float64 sums in the port, XLA convolutions in JAX: at most 1 bit of
  1.3 M measured);
- entropies within 1e-5 bits (float32 sums in another order; at most
  1.9e-6 measured), ch1's MSE within 1e-6 relative (a float32 mean over
  786,432 terms: JAX's is 4.8e-7 off the float64 value, the port's 0), the
  aliasing study's spectral energies within 1e-3 (the FIR decimate within
  4.6e-5 of JAX's).

Values are compared as printed, so each bound is widened by one unit of
the last printed digit: two numbers within ``t`` can print that far apart.
"""

from __future__ import annotations

import re

NUMBER = re.compile(r"-?\d+(?:\.\d+)?")

PSNR = ("abs", 0.01)
ENTROPY = ("abs", 1e-5)

# (line pattern, {number's index on the line: rule}); the first pattern that
# matches a reference line applies, and a number without a rule must print
# the same digits. A negative index counts from the line's end.
RULES = {
    "ch1_basics": [
        (r"^MSE", {0: ("rel", 1e-6)}),
        (r"^aliasing", {0: ("abs", 1e-3), 1: ("abs", 1e-3)}),
        (r"PSNR", {-1: PSNR}),
        (r"^  \w+ +\d", {1: PSNR}),  # method comparison rows: bpp, mean PSNR
    ],
    "ch2_entropy": [
        (r"^\w+: H=", {0: ENTROPY, 1: ENTROPY, 2: ENTROPY}),
        (r"min code length", {0: ENTROPY}),
        (r"^predictor entropies", {0: ENTROPY, 1: ENTROPY}),
        (r"^min-entropy predictor", {0: ENTROPY}),
        (r"^  q=", {1: ("rel", 3e-5), 2: PSNR}),
    ],
    "ch3_intra": [
        (r"^keep 64/64", {2: ("gt", 100.0)}),
        (r"PSNR", {-1: PSNR}),
    ],
    "ch4_video": [
        (r"^  q=", {2: PSNR}),
    ],
}


def _passes(rule, a: str, b: str) -> bool:
    if rule is None:
        return a == b
    x, y = float(a), float(b)
    kind, t = rule
    if kind == "gt":
        return x > t and y > t
    slack = 10.0 ** -len(a.partition(".")[2]) * (1 + 1e-9)  # one unit of the last digit
    return abs(x - y) <= (t * abs(x) if kind == "rel" else t) + slack


def mismatches(name: str, ref: list[str], got: list[str]) -> list[str]:
    """Every way ``got`` (lines of example ``name``) breaks the rules
    against ``ref``; empty when the two runs agree."""
    if len(got) != len(ref):
        return [f"{name}: {len(got)} lines, the reference has {len(ref)}"]
    out = []
    for r, g in zip(ref, got):
        if NUMBER.sub("#", g) != NUMBER.sub("#", r):
            out.append(f"{name}: {g!r} != {r!r}")
            continue
        rules = next((rs for pat, rs in RULES[name] if re.search(pat, r)), {})
        rs, gs = NUMBER.findall(r), NUMBER.findall(g)
        for k, (a, b) in enumerate(zip(rs, gs)):
            rule = rules.get(k, rules.get(k - len(rs)))
            if not _passes(rule, a, b):
                out.append(f"{name}: number {k} of {g!r} breaks {rule} against {r!r}")
    return out
