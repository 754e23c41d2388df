"""The configuration ``intra_1080p`` and its cell ``intra_1080p.request``: the
port's ``IntraCodec`` against the plain reference (``reference/intra.py``)
and its judge (``codec/IntraCodec/``) on seeded ``rgb_still`` images at
64x128 on the CPU; planted faults in the port and the controls read above
the cell's limits; the cell runs through the manifest."""

import json
import math

import pytest
import torch

from codec_bench import checks, harness
from codec_bench.calibrate import control_numbers
from codec_bench.reference import codec as ref
from codec_bench.reference import intra
from codec_bench.tests.tiny import BENCH, TINY

CELL = "intra_1080p.request"
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
JUDGE = harness.load(BENCH / "codec" / "IntraCodec" / "judge.py", "IntraCodec_judge")
RGB_STILL = harness.load(BENCH / "inputs" / "rgb_still.py", "input_rgb_still")
CFG = dict(json.loads((BENCH / "configs" / "intra_1080p.json").read_text()), **TINY)


def _coded(seed: int):
    """The clip's images, the port's codec trained as the cell's program
    trains it (on the first image, over the full alphabet), and the second
    image's container."""
    from ivclab_tpu_torch.models.intracodec import IntraCodec

    clip, units = RGB_STILL.make(seed, CFG, 4, "cpu")
    codec = IntraCodec(CFG["q"], device="cpu")
    codec.train_huffman_from_image(clip[0], bounds=codec.full_bounds())
    return units, codec, codec.encode_to_container(units[1])


@pytest.mark.parametrize("seed", [2**31 + 21, 2**31 + 22, 12345])
def test_the_port_equals_the_reference(seed):
    units, codec, blob = _coded(seed)
    parsed = JUDGE.parse(blob, "cpu", with_walks=True)
    assert parsed["good"]
    # the container holds the port's own symbols, in its block order
    x, _ = codec._prepare(units[1], True)
    _, _, qsym = codec._symbolize(x)
    assert torch.equal(intra.interleave(parsed["qsyms"]), qsym.to(torch.int64))
    # ... which are the reference's, but for a coefficient rounded apart
    own = intra.Intra(CFG["q"], "cpu").quantise(intra.to_ycc(units[1]))
    diff = (parsed["qsyms"] - own).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= own.numel() // 1000
    recon, ok = type(codec).decode_from_container(blob, device="cpu", return_device=True)
    nums = JUDGE.numbers(units[1], {"recons": recon, "trained_on": units[0]}, parsed, CFG,
                         "cpu")
    assert bool(ok) and set(nums) == set(JUDGE.NUMBERS) == set(LIMITS)
    assert all(nums[k] <= LIMITS[k] for k in LIMITS), nums
    # without the image the code was trained on, the rate is not judged
    assert "rate_gap" not in JUDGE.numbers(units[1], {"recons": recon}, parsed, CFG, "cpu")
    (walk,) = parsed["walks"]
    assert walk["kind"] == "canon" and walk["block_bits"].sum() == parsed["bits"]


@pytest.mark.parametrize("q", [0.05, 0.1, 0.15, 0.2, 0.3, 1.0])
def test_the_reference_s_full_alphabet_is_the_port_s(q):
    from ivclab_tpu_torch.models.intracodec import IntraCodec

    assert intra.full_alphabet(q) == IntraCodec(q, device="cpu").full_bounds()


def test_the_container_s_code_spans_the_full_alphabet():
    _, _, blob = _coded(2**31 + 25)
    code = intra.parse_container(blob)["code"]
    lo, hi = intra.full_alphabet(CFG["q"])
    assert (code["lower"], len(code["lengths"])) == (lo, hi - lo)


def test_the_reader_refuses_what_is_not_an_intra_container():
    _, _, blob = _coded(2**31 + 23)
    bad = bytearray(blob)
    bad[6] = 3  # another kind
    assert checks.parse(JUDGE, bytes(bad), "cpu") == {"good": False}
    cut = checks.parse(JUDGE, blob[: len(blob) // 2], "cpu")
    assert cut == {"good": False}
    flipped = bytearray(blob)
    flipped[-9] ^= 0x24  # a word of the last group's codes
    p = checks.parse(JUDGE, bytes(flipped), "cpu")
    assert not p["good"] or not torch.equal(p["qsyms"], JUDGE.parse(blob, "cpu")["qsyms"])


def test_the_reference_inverts_its_own_colour_and_transform():
    _, units = RGB_STILL.make(2**31 + 24, CFG, 1, "cpu")
    planes = intra.to_ycc(units[0])
    codec = intra.Intra(CFG["q"], "cpu")
    back = ref.from_blocks(codec.coefficients(planes)[0] @ codec.inv_t, *planes.shape[1:])
    assert float((back - planes[0]).abs().max()) < 1e-9
    assert float((intra.to_rgb(planes) - units[0]).abs().max()) < 1e-3
    # Cb and Cr take the chrominance table, Y the luminance one
    assert torch.equal(codec.qt[1], codec.qt[2]) and not torch.equal(codec.qt[0], codec.qt[1])


def _symbol_off_by_one(monkeypatch):
    """One symbol of every image off by one where the encoder produces it."""
    from ivclab_tpu_torch.models import intracodec
    from ivclab_tpu_torch.ops.zerorun import BLOCK_CAP, zerorun_encode_blocks

    original = intracodec.forward_symbolize

    def forward_symbolize(img, inv_qt, eob=4000):
        _, _, qsym = original(img, inv_qt, eob)
        qsym = qsym.clone()
        qsym[5, 0] += 1
        buf, valid_len = zerorun_encode_blocks(qsym, 64, eob, BLOCK_CAP)
        return buf, valid_len, qsym

    monkeypatch.setattr(intracodec, "forward_symbolize", forward_symbolize)


def _chroma_through_luma_table(monkeypatch):
    """The decoder dequantises Cb and Cr with the luminance table."""
    from ivclab_tpu_torch.models import intracodec

    original = intracodec.inverse_reconstruct
    monkeypatch.setattr(intracodec, "inverse_reconstruct",
                        lambda q, qt, shape: original(q, qt[:1].expand_as(qt), shape))


def _stale_codebook(monkeypatch):
    """The codebook trained at the RD sweep's previous point (q 0.1) and
    left in place at q 0.15."""
    from ivclab_tpu_torch.models.intracodec import IntraCodec

    original = IntraCodec.train_huffman_from_image

    def train(self, img, is_source_rgb=True, bounds=None):
        q = self.quantization_scale
        self.quantization_scale, self._qt_cache = q * JUDGE.STALE_Q, {}
        original(self, img, is_source_rgb, self.full_bounds())
        self.quantization_scale, self._qt_cache = q, {}

    monkeypatch.setattr(IntraCodec, "train_huffman_from_image", train)


def _clamped_to_the_alphabet(monkeypatch):
    """The codebook trained over a dimmed copy of the first image's own
    range, not the full alphabet: brighter blocks' symbols lie past it, and
    the pack clamps them to its edge."""
    from ivclab_tpu_torch.models.intracodec import IntraCodec

    original = IntraCodec.train_huffman_from_image
    monkeypatch.setattr(IntraCodec, "train_huffman_from_image",
                        lambda self, img, is_source_rgb=True, bounds=None:
                        original(self, img * 0.5, is_source_rgb))


FAULTS = {"symbol_off_by_one": (_symbol_off_by_one, "quant_excess"),
          "chroma_through_luma_table": (_chroma_through_luma_table, "recon_gap"),
          "stale_codebook": (_stale_codebook, "rate_gap"),
          "clamped_to_the_alphabet": (_clamped_to_the_alphabet, "quant_excess")}


def _run(tiny, seed=2**31 + 11, trace=False):
    return harness.run(tiny, CELL, seed, 1.0, trace, device="cpu", log=lambda s: None)


def test_the_cell_runs_through_the_manifest_and_is_correct(tiny):
    cell = harness.Cell(tiny, CELL)
    assert cell.cfg["codec"] == "IntraCodec" and cell.input.__file__.endswith("rgb_still.py")
    assert cell.traffic["depth"] == 1 and cell.loop.__file__.endswith("roundtrip.py")
    assert set(cell.limits) == set(cell.judge.NUMBERS)
    assert [m["name"] for m in cell.end_to_end] == ["p95_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "intra_encode_ms", "intra_decode_ms", "intra_syncs_per_image", "intra_walk_roofline_pct"]
    r = _run(tiny)
    assert r["correct"] and r["attempted"] >= 4 and r["failed"] == 0, r["checks"]
    assert set(r["checks"]) == set(LIMITS) | {"failed_gops"}
    assert set(r["metrics"]) == {"p95_ms", "setup_s"}


def test_a_traced_run_reads_the_ports_intra_spans(tiny):
    r = _run(tiny, trace=True)
    m = r["metrics"]
    assert r["correct"], r["checks"]
    assert m["intra_encode_ms"]["value"] > 0 and m["intra_decode_ms"]["value"] > 0
    # a read of a CPU tensor is no synchronisation; the roofline needs a card
    assert m["intra_syncs_per_image"]["value"] == 0
    assert "intra_walk_roofline_pct" not in m


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_port_is_not_correct(tiny, monkeypatch, fault):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    r = _run(tiny, seed=2**31 + 5)
    assert not r["correct"], r["checks"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"], r["checks"]


@pytest.mark.parametrize("kind,number", [("control", "quant_excess"), ("control", "recon_gap"),
                                         ("luma_table", "recon_gap"),
                                         ("stale_code", "rate_gap")])
def test_each_control_reads_above_its_limit(tiny, kind, number):
    for seed in (2**31 + 1, 2**31 + 2):
        nums = control_numbers(tiny, CELL, seed, "cpu", kind)
        assert nums[number] > LIMITS[number] and math.isfinite(nums[number]), nums
