"""The plain reference and the port agree at a tiny size on the CPU: the
transform, the motion search, the zero-run tokens, the codebooks' rates,
the containers as the reference reads them, and whole runs of each cell."""

import numpy as np
import pytest
import torch

from codec_bench import content, harness
from codec_bench.reference import codec as ref
from codec_bench.tests.tiny import ROOT

import json

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _clip(seed=3, frames=8):
    return content.clip(seed, frames, 64, 128, "cpu")


def test_clip_is_a_function_of_the_seed():
    a, b = _clip(2**31 + 7), _clip(2**31 + 7)
    assert torch.equal(a, b) and not torch.equal(a, _clip(2**31 + 8))
    assert a.dtype == torch.float32 and a.min() >= 0 and a.max() <= 255
    assert torch.equal(a, a.round())


def test_transform_and_quantiser_match_the_port():
    from ivclab_tpu_torch.ops.quant import quant_table_zigzag
    from ivclab_tpu_torch.ops.transform import forward_symbolize

    y = _clip()[0]
    qt = torch.from_numpy(quant_table_zigzag(1.0, 1))
    _, _, qsym = forward_symbolize(y[:, :, None], 1.0 / qt, 4000)
    tr = ref.Transform(1.0, "cpu")
    assert np.array_equal(ref.quant_table(1.0), qt[0].numpy().astype(np.float64))
    # integer pixels put some coefficients on a half step exactly, where
    # float32 and float64 may round apart: those alone may differ
    scaled = tr.coefficients(y) / tr.qt
    differ = tr.quantise(y) != qsym.to(torch.int64)
    assert int(differ.sum()) <= differ.numel() // 1000
    assert float(((scaled - qsym).abs() - 0.5).max()) < 1e-4


def test_motion_search_and_compensation_match_the_port():
    from ivclab_tpu_torch.ops.motion import motion_compensate, motion_search

    c = _clip()
    for sr in (1, 4):
        mv = motion_search(c[0], c[1], sr)
        assert torch.equal(ref.motion_search(c[0], c[1], sr), mv.to(torch.int64))
        assert torch.equal(ref.compensate(c[0].double(), mv, sr),
                           motion_compensate(c[0], mv, sr).double())


def test_zerorun_tokens_match_the_port():
    from ivclab_tpu_torch.ops.zerorun import zerorun_encode_blocks

    q = ref.Transform(0.5, "cpu").quantise(_clip()[0] - 128)
    buf, valid = zerorun_encode_blocks(q.to(torch.int32), 64, 4000, 128)
    toks, counts = ref.zerorun_tokens(q)
    assert torch.equal(counts, valid.to(torch.int64))
    assert torch.equal(toks, buf.to(torch.int64))
    blocks, ok = ref.zerorun_blocks(toks, counts)
    assert torch.equal(blocks, q) and bool(ok.all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codebook_rates_match_the_port(seed):
    from ivclab_tpu_torch.entropy.codebook import build_canonical_code, build_hot_code

    rng = np.random.default_rng(seed)
    hist = np.maximum(0, rng.geometric(0.02, 600) - 30).astype(np.int64)
    hist[rng.integers(0, 600, 50)] = 0
    hot = build_hot_code(hist, lower_bound=-40)
    mine = ref.HotCode.train(hist, -40)
    port_len = np.full(hist.size, hot.code.lengths[hot.K] + hot.raw_bits)
    port_len[hot.hot_values] = hot.code.lengths[:hot.K]
    assert (hist * port_len).sum() == (hist * mine.symbol_lengths()).sum()
    pmf = ref.smoothed_pmf(hist)
    port = build_canonical_code(pmf.astype(np.float32).astype(np.float64))
    assert (hist * port.lengths).sum() == (hist * ref.frame_code_lengths(hist)).sum()


@pytest.mark.parametrize("codec", ["FusedVideoCodec", "VideoCodec"])
def test_containers_read_as_the_port_wrote_them(codec):
    from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec
    from ivclab_tpu_torch.models.videocodec import VideoCodec

    c = _clip()
    if codec == "FusedVideoCodec":
        p = FusedVideoCodec(1.0, 4, device="cpu").train(c[:2])
        qsyms, mvs, _, _ = p.encode_gop(c)
        blob = p.encode_to_container(c)
    else:
        p = VideoCodec(1.0, codebook_policy="per-frame", device="cpu")
        blob = p.encode_to_container(c)
        from ivclab_tpu_torch.models.videocodec import _pframe_scan
        qt, inv_qt = p.intra_codec._tables(1)
        outs = _pframe_scan(c, range(8), inv_qt, qt, 4, 4000)
        mvs = outs[5]
        qsyms = None
    judge = harness.load(ROOT / "codec_bench" / "codec" / codec / "judge.py", f"{codec}_judge")
    parsed = judge.parse(blob, "cpu", with_walks=True)
    assert parsed["good"]
    assert torch.equal(parsed["mvs"][1:], mvs[1:].to(torch.int64))
    if qsyms is not None:
        assert torch.equal(parsed["qsyms"], qsyms.to(torch.int64))
    # the intra frame: the reference's own symbols (a P-frame's chain moves
    # apart from the first symbol rounded apart)
    q_ref = ref.Transform(1.0, "cpu").quantise(c[0])
    assert int((parsed["qsyms"][0] != q_ref).sum()) <= q_ref.numel() // 1000
    assert len(parsed["walks"]) == (2 if codec == "FusedVideoCodec" else 9)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_of_each_cell_is_correct_on_the_cpu(tiny, cell):
    r = harness.run(tiny, cell, 2**31 + 11, 1.5, False, device="cpu", log=lambda s: None)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in harness.Cell(tiny, cell).end_to_end}
    assert {"p95_ms", "setup_s"} <= set(r["metrics"])
    assert list(r)[-1] == "checks"
