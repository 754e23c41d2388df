"""The harness reads every cell's check exactly as before a configuration
could own its input and its check: the numbers below are what the harness
read before that change on the tiny checkout, on the CPU, for two fixed
seeds (each run judging clip GOPs 2 and 3; PyTorch 2.13 for the CPU, one
thread)."""

import pytest

from codec_bench import harness

KNOWN = {
    ("fused_1080p.stream", 2147483749): {
        "me_gap": 0.0, "quant_excess": 1.4210854715202004e-14,
        "recon_gap": 0.00010267267757058107, "rate_gap": 0.0},
    ("fused_1080p.stream", 12345): {
        "me_gap": 0.0, "quant_excess": 7.105427357601002e-15,
        "recon_gap": 8.662871545084272e-05, "rate_gap": 0.0016198704103671706},
    ("adaptive_1080p.stream", 2147483749): {
        "me_gap": 0.0, "quant_excess": 1.4210854715202004e-14,
        "recon_gap": 0.00010267267757058107, "rate_gap": 0.0},
    ("adaptive_1080p.stream", 12345): {
        "me_gap": 0.0, "quant_excess": 7.105427357601002e-15,
        "recon_gap": 8.662871545084272e-05, "rate_gap": 0.0},
    ("adaptive_1080p.decode", 2147483749): {
        "me_gap": 0.0, "quant_excess": 1.4210854715202004e-14,
        "recon_gap": 0.00010267267757058107, "rate_gap": 0.0},
    ("adaptive_1080p.decode", 12345): {
        "me_gap": 0.0, "quant_excess": 7.105427357601002e-15,
        "recon_gap": 8.662871545084272e-05, "rate_gap": 0.0},
}


@pytest.mark.parametrize("cell,seed", sorted(KNOWN))
def test_the_check_reads_the_known_answers(tiny, cell, seed):
    logs = []
    r = harness.run(tiny, cell, seed, 2.0, False, device="cpu", log=logs.append)
    assert any(s.startswith("check of 2 GOPs") for s in logs), logs
    assert r["correct"] and r["failed"] == 0
    assert {k: c["value"] for k, c in r["checks"].items()} == dict(KNOWN[cell, seed],
                                                                  failed_gops=0)
