"""The hot/escape decode walk (``ivclab_tpu_torch/ops/bitpack.py``).

The plain walk (``decode_blocks_hot_plain``, what ``decode_blocks_hot``
runs on the CPU) against JAX's ``decode_blocks_hot``, exactly, on two
kinds of stream: the local streams that the GOP codec's decode walks for
a real 128x256 8-frame GOP (the residual streams of the port's
``pack_gop`` and the MV streams of its IVC1 container, captured at the
walk's call sites), and ``fixtures.walk_streams``' corrupt streams, whose
edge cases a scalar walk here counts, so each case is known to occur.
The Hopper kernel (``csrc/decode_walk.cu``) against the plain walk on the
same inputs needs a card and skips elsewhere; JAX is imported only by the
CPU tests, so the card's cases run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    WALK_ARGS,
    assert_exact,
    captured_walks,
    cuda_device,
    port_args,
    walk,
)

import ivclab_tpu_torch.ops.bitpack as tbp
from ivclab_tpu_torch.utils import fixtures
from ivclab_tpu_torch.utils.timing import decode_walk_bound, kernel_base_name

M32 = 0xFFFFFFFF


def jax_walk(c) -> np.ndarray:
    """JAX's walk on the arguments, its tables in their own types."""
    import ivclab_tpu.ops.bitpack as jbp

    def host(x, dtype):
        return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x).astype(dtype)

    return np.asarray(jbp.decode_blocks_hot(
        host(c["local"], np.uint32), host(c["counts"], np.int32), host(c["lj"], np.uint32),
        host(c["first_code"], np.uint32), host(c["group_offset"], np.int32),
        host(c["alpha_of_rank"], np.int32), c["min_len"], c["esc_rank"], c["max_syms"],
        c["raw_bits"], c["max_len"]))


def hot_bounds(c) -> list[int]:
    """The bounds the walk compares: the first ``max_len - 1`` (one at
    ``max_len`` 1 and below)."""
    max_len = c["max_len"]
    return [int(v) for v in (c["lj"][: max_len - 1] if max_len > 1 else c["lj"][:1])]


def table_count(bounds, weights, bits=tbp.PREFIX_BITS):
    """The kernels' count of the bounds a window exceeds, in their order: the
    prefix table's entry, then compares against that prefix's inner
    bounds (``ops/bitpack.py::prefix_table``), in Python integers."""
    base, first, count, inner_v, inner_w = (t.tolist() for t in tbp.prefix_table(
        np.asarray(bounds, dtype=np.int64), np.asarray(weights, dtype=np.int64), bits))
    shift = 32 - bits

    def past(win: int) -> int:
        p = win >> shift
        return base[p] + sum(inner_w[k] for k in range(first[p], first[p] + count[p])
                             if win > inner_v[k])
    return past


def scalar_walk(c, count=None) -> tuple[np.ndarray, set, np.ndarray]:
    """The walk one block at a time in Python integers: its values, the
    edge cases it met on the way, and each block's bits walked. ``count``
    (a window -> the bounds it exceeds) replaces the compares."""
    local, counts = c["local"].astype(np.int64), c["counts"]
    B, LW = local.shape
    max_len, min_len, raw_bits = c["max_len"], c["min_len"], c["raw_bits"]
    max_syms, esc_rank = c["max_syms"], c["esc_rank"]
    lj = hot_bounds(c)
    if count is None:
        def count(win):
            return sum(win > v for v in lj)
    fc = [int(v) for v in c["first_code"]]
    go = [int(v) for v in c["group_offset"]]
    ar = [int(v) for v in c["alpha_of_rank"]]
    out = np.zeros((B, max_syms), dtype=np.int64)
    bits = np.zeros(B, dtype=np.int64)
    seen = set()
    if (counts < 0).any():
        seen.add("negative count")
    if (counts > max_syms).any():
        seen.add("count past max_syms")
    for b in range(B):
        words = [int(v) & M32 for v in local[b]]
        pos = 0
        for i in range(max(0, min(int(counts[b]), max_syms))):
            w, sh = pos >> 5, pos & 31
            if w + 1 >= LW:
                seen.add("read past the stream")
            w1 = words[w] if w < LW else 0
            w2 = words[w + 1] if w + 1 < LW else 0
            win = w1 if sh == 0 else ((w1 << sh) | (w2 >> (32 - sh))) & M32
            L = min_len + count(win)
            if 0 <= L <= max_len:
                fcv, gov = fc[L], go[L]
            else:
                seen.add("length outside [0, max_len]")
                fcv = gov = 0
            if 0 <= 32 - L < 32:
                code = win >> (32 - L)
            else:
                seen.add("shift outside [0, 32)")
                code = 0
            d = (code - fcv) & M32
            d = d - (1 << 32) if d >= 1 << 31 else d
            rank = ((gov + d + (1 << 31)) & M32) - (1 << 31)
            if rank != gov + d:
                seen.add("rank wraps int32")
            if not 0 <= rank < len(ar):
                seen.add("rank clamped")
            rank = min(max(rank, 0), len(ar) - 1)
            esc = rank == esc_rank
            if esc:
                seen.add("escape" if L >= 0 else "escape of negative length")
            raw = (((win << L) & M32) if 0 <= L < 32 else 0) >> (32 - raw_bits)
            value = raw if esc else ar[rank]
            out[b, i] = ((value + (1 << 31)) & M32) - (1 << 31)
            lu = (L + (raw_bits if esc else 0)) & M32
            if lu == 32:
                seen.add("32-bit advance")
            elif lu > 32:
                seen.add("advance past 32")
            pos += 32 if lu == 32 else lu & 31
        bits[b] = pos
    return out, seen, bits


# (min_len, esc_rank) -> the edge cases that its streams must meet (besides
# escapes, clamped ranks, advances past 32 bits, reads past the stream and
# out-of-range counts, which every case meets)
CORRUPT = {
    (-3, 4): {"length outside [0, max_len]", "shift outside [0, 32)", "rank wraps int32"},
    (-3, 0): {"escape of negative length"},
    (1, 4): {"32-bit advance", "rank wraps int32"},
    (9, 4): {"length outside [0, max_len]", "rank wraps int32"},
    (20, 4): {"length outside [0, max_len]", "shift outside [0, 32)"},
}


def corrupt_streams(min_len: int, esc_rank: int) -> dict:
    return fixtures.walk_streams(seed=100 + min_len + esc_rank, min_len=min_len,
                                 esc_rank=esc_rank)
EVERY_CASE = {"escape", "rank clamped", "advance past 32", "read past the stream",
              "negative count", "count past max_syms"}


@pytest.fixture(scope="module")
def gop_walks():
    mp = pytest.MonkeyPatch()
    try:
        return captured_walks(mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("stream", ["mv", "residual"])
def test_plain_walk_matches_jax_on_gop_streams(gop_walks, stream):
    c = gop_walks[stream]
    assert c["local"].device.type == "cpu"
    plain = walk(tbp.decode_blocks_hot_plain, c)
    assert_exact(plain, jax_walk(c), f"{stream} walk")
    assert_exact(walk(tbp.decode_blocks_hot, c), plain, f"{stream} dispatch")
    counts = c["counts"].numpy()
    assert plain.shape == (counts.shape[0], c["max_syms"]) and counts.max() > 0
    past = np.arange(c["max_syms"])[None, :] >= counts[:, None]
    assert not plain.numpy()[past].any(), "nonzero past a block's count"


@pytest.mark.parametrize("min_len,esc_rank", sorted(CORRUPT))
def test_plain_walk_matches_jax_on_corrupt_streams(min_len, esc_rank):
    c = corrupt_streams(min_len, esc_rank)
    want, seen, bits = scalar_walk(c)
    missing = (CORRUPT[min_len, esc_rank] | EVERY_CASE) - seen
    assert not missing, f"the streams never met {missing}"
    assert_exact(jax_walk(c), want, "JAX walk vs scalar walk")
    a = port_args(c)
    got, got_bits = tbp.decode_blocks_hot_plain(*(a[k] for k in WALK_ARGS), return_bits=True)
    assert_exact(got, want, "plain walk vs scalar walk")
    assert_exact(got_bits, bits, "bits walked")


def test_plain_walk_matches_jax_on_a_large_rank_table():
    """A rank table of 9,000 entries (the kernel reads it through the
    read-only cache, whatever its size), and an output width that is no
    multiple of 4."""
    c = fixtures.walk_streams(seed=7, n_ranks=9000, max_syms=37, raw_bits=12)
    want, _, _ = scalar_walk(c)
    assert_exact(jax_walk(c), want, "JAX walk vs scalar walk")
    assert_exact(walk(tbp.decode_blocks_hot_plain, port_args(c)), want, "plain walk")


def test_cuda_wrapper_refuses_cpu_tensors():
    """On the CPU the dispatcher walks the plain loop; the kernel's wrapper
    takes only CUDA tensors and counts no launch when it refuses."""
    c = port_args(fixtures.walk_streams(seed=3))
    before = tbp.WALK_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        walk(tbp.decode_blocks_hot_cuda, c)
    assert tbp.WALK_LAUNCHES == before
    assert_exact(walk(tbp.decode_blocks_hot, c), walk(tbp.decode_blocks_hot_plain, c), "dispatch")
    assert tbp.WALK_LAUNCHES == before


def test_decode_walk_bound_counts_each_byte_once():
    """The sectors of the words each block's bits lie in, its count and its
    output row: rows of 8 words start on 32-byte boundaries, rows of 3 words
    straddle them."""
    ms, by = decode_walk_bound([0, 1, 32, 33, 300], 8, 64)
    # 0, 1, 1, 2 and 8 words: 0, 1, 1, 1 and 2 sectors
    assert by == "bytes"
    assert ms == pytest.approx((5 * 32 + 5 * (4 + 64 * 4)) / 3.35e12 * 1e3)
    # rows at bytes 0 and 24, 3 words each: sectors [0, 1) and [0, 2)
    ms, _ = decode_walk_bound(np.array([96, 96]), 3, 5)
    assert ms == pytest.approx((3 * 32 + 2 * (4 + 5 * 4)) / 3.35e12 * 1e3)


# adversarial bound tables for the prefix table: (kind, min_len, max_len)
ADVERSARIAL = [("unsorted", 1, 16), ("duplicate", 1, 16), ("wild", -3, 16), ("inside", 20, 16),
               ("clustered", 1, 32), ("edges", 1, 32), ("inside", -3, 1), ("wild", 20, 32)]


def adversarial_streams(kind, min_len, max_len, B=512) -> dict:
    seed = 500 + 7 * min_len + max_len + tbp.PREFIX_BITS
    return fixtures.walk_streams(seed=seed, B=B, min_len=min_len, max_len=max_len,
                                 lj=fixtures.prefix_bounds(kind, seed, n=32))


def window_probes(bounds, bits, seed) -> np.ndarray:
    """Both ends of every prefix's range, each bound and its neighbours,
    and random windows, all in [0, 2^32)."""
    lo = np.arange(1 << bits, dtype=np.int64) << (32 - bits)
    v = np.asarray(bounds, dtype=np.int64)
    rng = np.random.default_rng(seed)
    w = np.concatenate([lo, lo + (1 << (32 - bits)) - 1, v - 1, v, v + 1,
                        rng.integers(0, 2**32, 4096, dtype=np.int64)])
    return w[(w >= 0) & (w < 2**32)]


@pytest.mark.parametrize("bits", [8, tbp.PREFIX_BITS])
@pytest.mark.parametrize("table", ["gop mv", "gop residual", "corrupt"] + list(
    fixtures.PREFIX_BOUND_KINDS))
def test_prefix_table_counts_as_the_compares(gop_walks, table, bits):
    """``prefix_table`` + ``prefix_count`` (the kernels' rule) against the
    full compare count, at both ends of every prefix's range, at each bound
    and its neighbours, and on random windows: the GOP's real hot codes,
    the corrupt fixture's sorted bounds and each adversarial kind."""
    if table.startswith("gop"):
        bounds = hot_bounds(gop_walks[table.split()[1]])
    elif table == "corrupt":
        bounds = hot_bounds(corrupt_streams(1, 4))
    else:
        bounds = fixtures.prefix_bounds(table, 17, n=63, bits=bits).tolist()
    v = torch.tensor(bounds, dtype=torch.int64)
    t = tbp.prefix_table(v, torch.ones_like(v), bits)
    assert t[0].shape == (1 << bits,) and int(t[2].sum()) == t[3].shape[0]
    win = torch.from_numpy(window_probes(bounds, bits, 3))
    want = (win[:, None] > v[None, :]).sum(dim=1)
    assert_exact(tbp.prefix_count(win, t), want, f"{table} counts")
    if table in ("inside", "clustered"):
        assert int(t[2].sum()) == len(bounds), "every bound lies inside a prefix's range"


@pytest.mark.parametrize("case", [("corrupt",) + k for k in sorted(CORRUPT)] + ADVERSARIAL,
                         ids=str)
def test_table_walk_matches_plain_walk(case):
    """A scalar walk that counts by the prefix table, in the kernels' order
    (the table's entry, else compares against the prefix's inner bounds),
    equals ``decode_blocks_hot_plain`` on the corrupt fixtures and on the
    adversarial tables: unsorted, repeated, negative and >= 2^32 bounds,
    bounds inside prefixes and at their edges, ``min_len`` -3 and 20,
    ``max_len`` 1 and 32."""
    c = corrupt_streams(*case[1:]) if case[0] == "corrupt" else adversarial_streams(*case)
    bounds = hot_bounds(c)
    want, _, bits = scalar_walk(c, table_count(bounds, [1] * len(bounds)))
    a = port_args(c)
    got, got_bits = tbp.decode_blocks_hot_plain(*(a[k] for k in WALK_ARGS), return_bits=True)
    assert_exact(got, want, f"plain walk vs table walk ({case})")
    assert_exact(got_bits, bits, "bits walked")


def test_kernel_base_name_matches_exactly():
    """The profiler's kernel names reduce to the function's own name, so
    ``walk_kernel`` is not found in ``canon_walk_kernel``, and a templated
    or mangled name is still found."""
    cases = {
        "(anonymous namespace)::walk_kernel(long long const*, int, int, int const*, "
        "(anonymous namespace)::Tables, int, int*)": "walk_kernel",
        "void (anonymous namespace)::canon_walk_kernel(long long const*, long long, int const*, "
        "int const*, int, (anonymous namespace)::CanonTables, int, int*)": "canon_walk_kernel",
        "void (anonymous namespace)::me_kernel<4>(float const*, float const*, int*, int)":
            "me_kernel",
        "walk_kernel<10>": "walk_kernel",
        "_ZN12_GLOBAL__N_111walk_kernelEPKxiiPKiNS_6TablesEiPi": "walk_kernel",
        "_ZN12_GLOBAL__N_19me_kernelILi4EEEvPKfS2_Pii": "me_kernel",
        "_Z17canon_walk_kernelPKxxPKiS2_i": "canon_walk_kernel",
        "spin_kernel": "spin_kernel",
    }
    for name, want in cases.items():
        assert kernel_base_name(name) == want, name


# the kernel on the card: every case above, a walk of no blocks, and the
# adversarial tables
KERNEL_CASES = sorted(CORRUPT) + [None] + ADVERSARIAL  # None: the large rank table, 333 blocks


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_kernel_matches_plain_walk_on_corrupt_streams(cuda_device, case):
    if case is None:
        c = fixtures.walk_streams(seed=7, B=333, n_ranks=9000, max_syms=37, raw_bits=12)
    elif len(case) == 3:
        c = adversarial_streams(*case, B=333)
    else:
        c = corrupt_streams(*case)
    args = port_args(c, cuda_device)
    before = tbp.WALK_LAUNCHES
    got = walk(tbp.decode_blocks_hot, args)
    torch.cuda.synchronize()
    assert tbp.WALK_LAUNCHES == before + 1
    assert_exact(got, walk(tbp.decode_blocks_hot_plain, args), f"kernel vs plain ({case})")


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["mv", "residual"])
def test_kernel_matches_plain_walk_on_gop_streams(cuda_device, monkeypatch, stream):
    c = captured_walks(monkeypatch, cuda_device)[stream]
    assert c["local"].is_cuda
    got = walk(tbp.decode_blocks_hot_cuda, c)
    assert_exact(got, walk(tbp.decode_blocks_hot_plain, c), f"kernel vs plain ({stream})")
    empty = dict(c, local=c["local"][:0], counts=c["counts"][:0])
    assert walk(tbp.decode_blocks_hot_cuda, empty).shape == (0, c["max_syms"])
