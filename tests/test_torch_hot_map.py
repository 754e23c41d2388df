"""The GOP codec's map (``ivclab_tpu_torch/ops/transform.py::map_gop_hot``).

On the CPU: ``map_gop_hot`` (the plain chain it runs for CPU tensors)
against the chain written out (``zerorun_encode_blocks`` ->
``map_codes_hot`` -> ``pack_extents``, ``valid.max() <= cap``) and against
JAX's ``_map_gop_hot``, bit for bit, at caps 32, 64 and 128, on blocks past
the cap (all non-zero: 65 symbols; alternating: 97), all-zero blocks,
symbols below the lower bound and at or past ``2^raw_bits``, and duplicate
hot values; each case checks that its edges occur. Also the dispatch for
CPU tensors, the CUDA wrapper's refusals, and
``utils/timing.py::hot_map_bound``.

On a card (``cuda``; skipped elsewhere): the Hopper map kernel
(``csrc/grouped_pack.cu::map_kernel``) against the plain chain, every
output bit for bit, at the callers' shapes and on the same adversarial
blocks; its counters; a warm ``FusedVideoCodec.pack_gop`` mapping through it
once. JAX is imported only by the CPU parity test, so the card's cases run
where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_exact, cuda_device  # noqa: F401

import ivclab_tpu_torch.ops.transform as ttr
from ivclab_tpu_torch.entropy.codebook import build_hot_code
from ivclab_tpu_torch.ops.zerorun import zerorun_encode_blocks
from ivclab_tpu_torch.runtime import trace
from ivclab_tpu_torch.utils.timing import H100_HBM_BYTES_PER_S, hot_map_bound

EOB = 4000
OUTPUTS = ("codes", "lens", "valid", "bw_max", "gw_max", "cap_ok")


def make_blocks(seed: int, N: int, kind: str) -> torch.Tensor:
    """Seeded ``[N, 64]`` int32 quantised blocks (N a multiple of 16):
    ``codec`` a few low-frequency non-zeros a block, Laplacian values, as the
    codec's residuals give; ``adversarial`` random densities with, among
    them, all-zero blocks, all non-zero blocks (65 symbols), alternating
    zero / non-zero blocks (97, the worst case), a lone last coefficient,
    and blocks of values up to 2^25 in magnitude."""
    rng = np.random.default_rng(seed)
    if kind == "codec":
        n = np.minimum(rng.geometric(0.25, N) - 1, 32)
        q = np.where(np.arange(64)[None, :] < 2 * n[:, None],
                     np.round(rng.laplace(0.0, 1.5, (N, 64))), 0)
    elif kind == "adversarial":
        q = rng.integers(-40, 41, (N, 64)) * (rng.random((N, 64)) < rng.random((N, 1)))
        rows = rng.permutation(N)
        q[rows[0::8]] = 0
        full = rows[1::8]
        q[full] = rng.integers(1, 9, (full.size, 64)) * rng.choice([-1, 1], (full.size, 64))
        alt = rows[2::8]
        q[alt] = 0
        q[alt, 1::2] = rng.integers(1, 50, (alt.size, 32))
        lone = rows[3::8]
        q[lone] = 0
        q[lone, 63] = rng.integers(1, 9, lone.size)
        big = rows[4::8]
        q[big] = rng.integers(-2**25, 2**25, (big.size, 64))
    else:
        raise ValueError(kind)
    return torch.from_numpy(q.astype(np.int32))


def trained_tables(qsyms: torch.Tensor):
    """(hot_values, hot_fused, esc_code, esc_len, lower_bound, raw_bits) of a
    hot/escape code trained on the blocks' own symbols, as the codec trains."""
    from ivclab_tpu_torch.models.fastvideo import _encode_tables

    buf, valid = zerorun_encode_blocks(qsyms, 64, EOB, 128)
    in_count = torch.arange(128)[None, :] < valid[:, None]
    syms = buf[in_count].numpy().astype(np.int64)
    lo = int(syms.min())
    code = build_hot_code(np.bincount(syms - lo), lower_bound=lo)
    hv, hf, esc_code, esc_len = _encode_tables(code, "cpu")
    return hv, hf, esc_code, esc_len, lo, code.raw_bits


def raw_tables(seed: int, raw_bits: int, K: int, lower_bound: int):
    """Seeded hot tables in ``[0, 2^raw_bits)`` with duplicate values (and
    the table's two edges) where K allows, random 32-bit fused entries."""
    rng = np.random.default_rng(seed)
    hv = rng.integers(0, 2**raw_bits, K)
    if K > 5:
        hv[1], hv[-1] = hv[0], hv[2]
        hv[3], hv[4] = 0, 2**raw_bits - 1
    hf = rng.integers(0, 2**32, K)
    esc_code = int(rng.integers(0, 2**(32 - raw_bits)))
    esc_len = int(rng.integers(0, 32 - raw_bits + 1))
    return (torch.from_numpy(hv), torch.from_numpy(hf), esc_code, esc_len, lower_bound,
            raw_bits)


# (name, blocks, tables): a trained code on codec-like blocks, and raw tables
# at the narrowest, the codec's and the widest raw_bits on adversarial ones
TABLES = [
    ("trained", "codec", None),
    ("raw_bits 1, K 2", "adversarial", (1, 2, 0)),
    ("raw_bits 13, K 127, duplicates", "adversarial", (13, 127, -20)),
    ("raw_bits 24, K 40, duplicates", "adversarial", (24, 40, -3)),
    ("no hot values", "adversarial", (8, 0, 5)),
]
CASES = [(cap, *t) for cap in (32, 64, 128) for t in TABLES]
CASE_IDS = [f"cap{cap}-{name}" for cap, name, _, _ in CASES]


def case_args(cap: int, name: str, kind: str, raw, N: int = 256):
    qsyms = make_blocks(cap + len(name), N, kind)
    tables = trained_tables(qsyms) if raw is None else raw_tables(cap + raw[0], *raw)
    return qsyms, tables


def edges(qsyms, tables, cap: int) -> set:
    """Which of the map's edge cases the blocks and tables exercise."""
    hv, hf, esc_code, esc_len, lb, raw_bits = tables
    buf, valid = zerorun_encode_blocks(qsyms, 64, EOB, 128)
    in_count = torch.arange(128)[None, :] < valid[:, None]
    sym = buf.to(torch.int64)[in_count] - lb
    found = set()
    if bool((valid > cap).any()):
        found.add("over cap")
    if int(valid.max()) == 97:
        found.add("97 symbols")
    if bool((valid == 1).any()):
        found.add("all zero")
    if bool((sym < 0).any()):
        found.add("below lower bound")
    if bool((sym >= 2**raw_bits).any()):
        found.add("past 2^raw_bits")
    if torch.as_tensor(hv).unique().numel() < torch.as_tensor(hv).numel():
        found.add("duplicate hot values")
    return found


def plain_chain(qsyms, tables, cap: int):
    hv, hf, esc_code, esc_len, lb, raw_bits = tables
    buf, valid = zerorun_encode_blocks(qsyms, 64, EOB, cap)
    codes, lens = ttr.map_codes_hot(buf - lb, valid, hv, hf, esc_code, esc_len, raw_bits)
    bw_max, gw_max = ttr.pack_extents(lens)
    return codes, lens, valid, bw_max, gw_max, valid.max() <= cap


@pytest.mark.parametrize("cap,name,kind,raw", CASES, ids=CASE_IDS)
def test_map_gop_hot_equals_the_plain_chain_and_jax(cap, name, kind, raw):
    import jax.numpy as jnp

    from ivclab_tpu.models import fastvideo as jfv

    qsyms, tables = case_args(cap, name, kind, raw)
    found = edges(qsyms, tables, cap)
    if kind == "adversarial":
        assert {"all zero", "below lower bound", "past 2^raw_bits", "97 symbols"} <= found
        assert "over cap" in found or cap == 128
        assert "duplicate hot values" in found or raw[1] < 6
    got = ttr.map_gop_hot(qsyms, *tables[:4], tables[4], cap, tables[5], EOB)
    for what, g, w in zip(OUTPUTS, got, plain_chain(qsyms, tables, cap)):
        assert g.dtype == w.dtype, what
        assert_exact(g, w, f"{what} ({name}, cap {cap})")
    hv, hf, esc_code, esc_len, lb, raw_bits = tables
    ref = jfv._map_gop_hot(jnp.asarray(qsyms.numpy()[None]),
                           jnp.asarray(hv.numpy().astype(np.int32)),
                           jnp.asarray(hf.numpy().astype(np.uint32)), esc_code, esc_len, lb, cap,
                           raw_bits)
    for what, g, r in zip(OUTPUTS, got, ref):
        assert_exact(g, np.asarray(r), f"{what} against JAX ({name}, cap {cap})")


def test_cpu_symbols_take_the_plain_chain():
    qsyms, tables = case_args(64, "trained", "codec", None)
    before = ttr.MAP_LAUNCHES
    trace.enable()
    try:
        got = ttr.map_gop_hot(qsyms, *tables[:4], tables[4], 64, tables[5])
        counts = trace.summary()["counts"]
    finally:
        trace.disable()
        trace.reset()
    assert ttr.MAP_LAUNCHES == before and "map_kernel" not in counts
    for what, g, w in zip(OUTPUTS, got, ttr.map_gop_hot_plain(qsyms, *tables[:4], tables[4], 64,
                                                              tables[5])):
        assert_exact(g, w, f"{what}: dispatch on the CPU")


def _good_args():
    qsyms, tables = case_args(64, "raw_bits 13, K 127, duplicates", "adversarial", (13, 127, -20),
                              N=64)
    hv, hf, esc_code, esc_len, lb, raw_bits = tables
    return dict(qsyms=qsyms, hot_values=hv, hot_fused=hf, esc_code=esc_code, esc_len=esc_len,
                lower_bound=lb, cap=64, raw_bits=raw_bits)


# (what, the arguments changed, a word of the refusal): every one is refused
# before anything is allocated on a device or counted
REFUSALS = [
    ("CPU symbols", {}, "CUDA"),
    ("float symbols", {"qsyms": lambda a: a["qsyms"].double()}, "integer"),
    ("bool symbols", {"qsyms": lambda a: a["qsyms"] != 0}, "integer"),
    ("63 coefficients", {"qsyms": lambda a: a["qsyms"][:, :63]}, "[N, 64]"),
    ("one dimension", {"qsyms": lambda a: a["qsyms"].reshape(-1)}, "[N, 64]"),
    ("N not a multiple of 16", {"qsyms": lambda a: a["qsyms"][:-8]}, "multiple"),
    ("no blocks", {"qsyms": lambda a: a["qsyms"][:0]}, "multiple"),
    ("cap 0", {"cap": 0}, "cap"),
    ("cap past the kernel's", {"cap": ttr.MAP_MAX_CAP + 1}, "cap"),
    ("raw_bits 0", {"raw_bits": 0}, "raw_bits"),
    ("raw_bits 25", {"raw_bits": 25}, "raw_bits"),
    ("negative escape length", {"esc_len": -1}, "esc_len"),
    ("escape past 63 bits", {"esc_len": 51}, "esc_len"),
    ("lower bound past int32", {"lower_bound": 2**31}, "int32"),
    ("fused entries short", {"hot_fused": lambda a: a["hot_fused"][:-1]}, "hot values"),
    ("too many hot values", {"hot_values": torch.zeros(ttr.MAP_MAX_HOT + 1, dtype=torch.int64),
                             "hot_fused": torch.zeros(ttr.MAP_MAX_HOT + 1, dtype=torch.int64)},
     "hot values"),
]


@pytest.mark.parametrize("what,change,word", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_the_cuda_wrapper_refuses_without_counting(what, change, word):
    args = _good_args()
    args.update({k: v(args) if callable(v) else v for k, v in change.items()})
    before = ttr.MAP_LAUNCHES
    with pytest.raises(ValueError, match=word.replace("[", r"\[").replace("]", r"\]")):
        ttr.map_gop_hot_cuda(**args)
    assert ttr.MAP_LAUNCHES == before


@pytest.mark.parametrize("N,cap,K,want_bytes", [
    (261_120, 64, 0, 261_120 * (256 + 64 * 12 + 4) + 17),
    (261_120, 128, 127, 261_120 * (256 + 128 * 12 + 4) + 127 * 16 + 17),
    (16, 1, 1, 16 * (256 + 12 + 4) + 16 + 17),
])
def test_hot_map_bound_counts_each_byte_once(N, cap, K, want_bytes):
    ms, by = hot_map_bound(N, cap, K)
    assert by == "bytes"
    assert ms == pytest.approx(want_bytes / H100_HBM_BYTES_PER_S * 1e3, rel=1e-12)
    if (N, cap) == (261_120, 64):
        assert 0.0800 < ms < 0.0802  # the 1080p GOP's map at cap 64: 268.4 MB
    if (N, cap) == (261_120, 128):
        assert 0.1399 < ms < 0.1401  # and at cap 128: 469.0 MB


# ----------------------------------------------------------------- the card


def to_card(dev, qsyms, tables):
    hv, hf, *rest = tables
    return qsyms.to(dev), (hv.to(dev), hf.to(dev), *rest)


def assert_kernel_equals_plain(qsyms, tables, cap: int, what: str):
    before = ttr.MAP_LAUNCHES
    got = ttr.map_gop_hot(qsyms, *tables[:4], tables[4], cap, tables[5])
    torch.cuda.synchronize()
    assert ttr.MAP_LAUNCHES == before + 1
    want = ttr.map_gop_hot_plain(qsyms, *tables[:4], tables[4], cap, tables[5])
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_cuda, f"{name} ({what})"
        assert_exact(g, w, f"{name} ({what})")


# (what, T * N blocks, caps): the fused codec's 1080p GOP, a 272-row band of
# the sharded path's 2 x 4 mesh, the tests' 128 x 256 GOP, one group
CALLER_SHAPES = [
    ("fused 1080p GOP", 8 * 136 * 240, (32, 64, 128)),
    ("sharded band 272x1920", 8 * 34 * 240, (64,)),
    ("128x256 GOP", 8 * 16 * 32, (32, 64, 128)),
    ("one group", 16, (32, 128)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("what,N,caps", CALLER_SHAPES, ids=[c[0] for c in CALLER_SHAPES])
def test_kernel_equals_plain_at_the_callers_shapes(cuda_device, what, N, caps):
    qsyms = make_blocks(N, N, "codec")
    tables = trained_tables(qsyms[:4096])
    for cap in caps:
        assert_kernel_equals_plain(*to_card(cuda_device, qsyms, tables), cap, f"{what}, cap {cap}")


@pytest.mark.cuda
@pytest.mark.parametrize("cap,name,kind,raw", CASES, ids=CASE_IDS)
def test_kernel_equals_plain_on_adversarial_blocks(cuda_device, cap, name, kind, raw):
    for seed_n in (256, 4096):
        qsyms, tables = case_args(cap, name, kind, raw, N=seed_n)
        assert_kernel_equals_plain(*to_card(cuda_device, qsyms, tables), cap, f"{name}, N {seed_n}")


@pytest.mark.cuda
def test_the_kernel_takes_its_largest_tables_and_caps(cuda_device):
    qsyms = make_blocks(9, 512, "adversarial")
    tables = raw_tables(9, 12, ttr.MAP_MAX_HOT, -7)
    for cap in (1, 97, ttr.MAP_MAX_CAP):
        assert_kernel_equals_plain(*to_card(cuda_device, qsyms, tables), cap, f"cap {cap}")


@pytest.mark.cuda
def test_each_launch_is_counted(cuda_device):
    qsyms, tables = to_card(cuda_device, *case_args(64, "trained", "codec", None))
    before = ttr.MAP_LAUNCHES
    trace.enable()
    try:
        with trace.span("outer"):
            for _ in range(3):
                ttr.map_gop_hot(qsyms, *tables[:4], tables[4], 64, tables[5])
        summary = trace.summary()
    finally:
        trace.disable()
        trace.reset()
    assert ttr.MAP_LAUNCHES == before + 3
    assert summary["counts"]["map_kernel"] == 3


@pytest.mark.cuda
def test_a_warm_fused_pack_maps_through_the_kernel_once(cuda_device):
    from ivclab_tpu_torch import FusedVideoCodec
    from ivclab_tpu_torch.utils import fixtures

    y = np.ascontiguousarray(fixtures.video("bench", 8, (128, 256)).astype(np.float32).mean(-1))
    fused = FusedVideoCodec(1.0, device=cuda_device).train(y[:2])
    qsyms, *_ = fused.encode_gop(torch.from_numpy(y).to(cuda_device))
    fused.pack_gop(qsyms)  # the first GOP picks the sticky buckets
    before = ttr.MAP_LAUNCHES
    trace.enable()
    try:
        p = fused.pack_gop(qsyms, check=False)
        torch.cuda.synchronize()
        counts = trace.summary()["counts"]
    finally:
        trace.disable()
        trace.reset()
    assert ttr.MAP_LAUNCHES == before + 1 and counts["map_kernel"] == 1 and bool(p.ok)

    cpu = FusedVideoCodec(1.0, device="cpu")
    cpu.set_residual_code(fused.residual_code)
    cpu._buckets = fused._buckets
    want = cpu.pack_gop(qsyms.cpu(), check=False)
    for name, g, w in zip(p._fields, p, want):
        if isinstance(g, torch.Tensor):
            assert_exact(g, w, f"PackedGop.{name}")
        else:
            assert g == w, f"PackedGop.{name}"
