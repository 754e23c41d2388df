"""The canonical decode walk (``ivclab_tpu_torch/ops/bitpack.py``).

The plain walk (``decode_blocks_device_plain``, what
``decode_blocks_device`` runs on the CPU) against JAX's
``decode_blocks_device``, exactly, on two kinds of stream: the streams
that the intra and adaptive video decoders really walk at 128x256
(captured at their call sites by ``torch_parity.captured_canon_walks``),
and ``fixtures.canon_walk_streams``' corrupt streams, whose edge cases a
scalar walk here counts, so each case is known to occur. Among them are
the block offsets that JAX reads by its gather's index rule: negative
ones count from the stream's end, and int32 bit positions wrap at 2^31.
The Hopper kernel (``canon_walk_kernel`` in ``csrc/decode_walk.cu``)
against the plain walk on the same inputs needs a card and skips
elsewhere; JAX is imported only by the CPU tests, so the card's cases run
where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_exact, captured_canon_walks, cuda_device  # noqa: F401

import ivclab_tpu_torch.ops.bitpack as tbp
from ivclab_tpu_torch.entropy.codebook import build_canonical_code
from ivclab_tpu_torch.utils import fixtures
from ivclab_tpu_torch.utils.timing import canon_walk_bound

M32 = 0xFFFFFFFF


def as_numpy(call) -> dict:
    """A captured call's arguments in the JAX tables' types."""
    lj, fc, go, ss, min_len, max_len = call["tables"]

    def host(x, dtype):
        return x.cpu().numpy().astype(dtype)

    return {"words": host(call["words"], np.uint32), "offsets": host(call["offsets"], np.int32),
            "counts": host(call["counts"], np.int32), "lj": host(lj, np.uint32),
            "first_code": host(fc, np.uint32), "group_offset": host(go, np.int32),
            "sorted_syms": host(ss, np.int32), "min_len": min_len, "max_len": max_len,
            "max_syms": call["max_syms"]}


def port(c, device="cpu") -> tuple:
    """(words, offsets, counts, tables, max_syms) as the port takes them."""
    def t(k):
        return torch.from_numpy(np.asarray(c[k]).astype(np.int64)).to(device)

    tables = (t("lj"), t("first_code"), t("group_offset"), t("sorted_syms"), c["min_len"],
              c["max_len"])
    return (t("words"), t("offsets").to(torch.int32), t("counts").to(torch.int32), tables,
            c["max_syms"])


def jax_walk(c) -> np.ndarray:
    import ivclab_tpu.ops.bitpack as jbp

    tables = (c["lj"].astype(np.uint32), c["first_code"].astype(np.uint32),
              c["group_offset"].astype(np.int32), c["sorted_syms"].astype(np.int32),
              np.int32(c["min_len"]))
    return np.asarray(jbp.decode_blocks_device(
        c["words"].astype(np.uint32), c["offsets"].astype(np.int32),
        c["counts"].astype(np.int32), tables, c["max_syms"]))


def i32(v: int) -> int:
    return ((v + (1 << 31)) & M32) - (1 << 31)


def canon_bounds(c) -> tuple[list[int], list[int]]:
    """The bounds the port's walks compare and their weights: the first
    ``max_len`` (taken modulo 2^32), the last of them weighing 32 -
    ``max_len`` (it stands for the bounds past ``max_len``)."""
    max_len = c["max_len"]
    bounds = [int(v) & M32 for v in np.asarray(c["lj"], dtype=np.int64)[:max_len]]
    return bounds, [1] * (max_len - 1) + [32 - max_len]


def table_count(bounds, weights, bits=tbp.PREFIX_BITS):
    """The kernels' count of the bound weight a window exceeds, in their
    order: the prefix table's entry, then compares against that prefix's
    inner bounds (``ops/bitpack.py::prefix_table``), in Python integers."""
    base, first, count, inner_v, inner_w = (t.tolist() for t in tbp.prefix_table(
        np.asarray(bounds, dtype=np.int64), np.asarray(weights, dtype=np.int64), bits))
    shift = 32 - bits

    def past(win: int) -> int:
        p = win >> shift
        return base[p] + sum(inner_w[k] for k in range(first[p], first[p] + count[p])
                             if win > inner_v[k])
    return past


def scalar_walk(c, count=None) -> tuple[np.ndarray, set, np.ndarray]:
    """JAX's walk one block at a time in Python integers (all 31 bounds
    compared): its values, the edge cases it met on the way, and each
    block's bits walked. ``count`` (a window -> the bound weight it
    exceeds) replaces the compares."""
    words = [int(v) for v in c["words"]]
    n = len(words)
    lj = [int(v) for v in c["lj"][:31]]
    if count is None:
        def count(win):
            return sum(win > v for v in lj)
    fc = [int(v) for v in c["first_code"]]
    go = [int(v) for v in c["group_offset"]]
    ss = [int(v) for v in c["sorted_syms"]]
    min_len, max_syms = c["min_len"], c["max_syms"]
    offs, counts = c["offsets"], c["counts"]
    B = offs.shape[0]
    out = np.zeros((B, max_syms), dtype=np.int64)
    bits = np.zeros(B, dtype=np.int64)
    seen = set()
    if (counts < 0).any():
        seen.add("negative count")
    if (counts > max_syms).any():
        seen.add("count past max_syms")

    def index(k):
        if k < 0:
            seen.add("word index from the end" if k >= -n else "word index clamped to 0")
            k += n
        if k >= n:
            seen.add("read past the stream")
        return min(max(k, 0), n - 1)

    for b in range(B):
        pos = int(offs[b])
        steps = max(0, min(int(counts[b]), max_syms))
        if steps and pos < 0:
            seen.add("negative offset")
        for i in range(steps):
            w, sh = pos >> 5, pos & 31
            w1 = words[index(w)]
            w2 = words[index(min(w + 1, n - 1))]
            win = w1 if sh == 0 else ((w1 << sh) | (w2 >> (32 - sh))) & M32
            L = min_len + count(win)
            if L == 32:
                seen.add("32-bit code")
            elif L > 32:
                seen.add("length past 32")
            code = win >> (32 - L) if 1 <= L <= 32 else 0
            Lc = min(L, 32)
            idx = go[Lc] + i32((code - fc[Lc]) & M32)
            if i32(idx) != idx:
                seen.add("rank wraps int32")
            idx = i32(idx)
            if not 0 <= idx < len(ss):
                seen.add("symbol index clamped")
            out[b, i] = ss[min(max(idx, 0), len(ss) - 1)]
            if pos + L >= 1 << 31:
                seen.add("bit position wraps past 2^31")
            pos = i32(pos + L)
            bits[b] += L
    return out, seen, bits


# every corrupt case meets these
EVERY_CASE = {"negative offset", "word index from the end", "word index clamped to 0",
              "read past the stream", "bit position wraps past 2^31", "negative count",
              "count past max_syms"}
# (code, min_len, n_sym, max_syms) -> the edge cases its streams must also meet
CORRUPT = {
    ("random", 1, 300, 40): {"rank wraps int32", "symbol index clamped", "32-bit code"},
    ("random", 9, 300, 40): {"rank wraps int32", "symbol index clamped", "length past 32"},
    ("random", 1, 70000, 37): {"rank wraps int32", "symbol index clamped"},
    ("skewed", None, None, 40): {"32-bit code"},
    ("laplacian", None, 9000, 40): set(),
}


def corrupt_streams(code, min_len, n_sym, max_syms, B=512) -> dict:
    kw = {"min_len": min_len} if min_len is not None else {}
    if n_sym is not None:
        kw["n_sym"] = n_sym
    return fixtures.canon_walk_streams(seed=300 + (min_len or 0) + max_syms, B=B,
                                       max_syms=max_syms, code=code, **kw)


@pytest.fixture(scope="module")
def codec_walks():
    mp = pytest.MonkeyPatch()
    try:
        return captured_canon_walks(mp)
    finally:
        mp.undo()


def test_bit_window_follows_jax_index_rule():
    """Windows at positions in every band: inside the stream, past it,
    negative within one stream length and below it, and near +-2^31."""
    import jax

    import ivclab_tpu.ops.bitpack as jbp

    rng = np.random.default_rng(11)
    words = rng.integers(0, 2**32, 10, dtype=np.uint64).astype(np.uint32)
    pos = np.concatenate([rng.integers(-2**31, 2**31, 300), np.arange(-400, 400, 7),
                          [-1, -31, -32, -33, -320, -321, 319, 320, 351, 352,
                           2**31 - 1, 2**31 - 33, -2**31, -2**31 + 31]]).astype(np.int32)
    want = jax.vmap(lambda p: jbp.bit_window32(words, p))(pos)
    got = tbp.bit_window32(torch.from_numpy(words.astype(np.int64)), torch.from_numpy(pos))
    assert_exact(got, np.asarray(want), "32-bit windows")


@pytest.mark.parametrize("offsets", [[-1, -33, -9595, -7], [2**31 - 40, 2**31 - 1, 2**31 - 64, 5]],
                         ids=["negative", "crossing 2^31"])
def test_plain_walk_matches_jax_on_wrapping_offsets(offsets):
    """Offsets a corrupt container's int32 cast gives: the Laplacian code
    of the intra tests, 300 random words, 20 symbols a block."""
    lap = np.exp(-np.abs(np.arange(301) - 150) / 6.0) + 1e-9
    code = build_canonical_code(lap / lap.sum(), lower_bound=-150, max_len=16)
    c = {"words": np.random.default_rng(1).integers(0, 2**32, 300).astype(np.uint32),
         "offsets": np.asarray(offsets, dtype=np.int64).astype(np.int32),
         "counts": np.full(4, 20, dtype=np.int32),
         "lj": np.asarray(code.lj_next_minus1, dtype=np.uint32),
         "first_code": np.asarray(code.first_code, dtype=np.uint32),
         "group_offset": np.asarray(code.group_offset, dtype=np.int32),
         "sorted_syms": np.asarray(code.sorted_syms, dtype=np.int32),
         "min_len": int(code.min_len), "max_len": int(code.max_len), "max_syms": 20}
    want = jax_walk(c)
    assert_exact(scalar_walk(c)[0], want, "scalar walk vs JAX")
    tables = tbp.decode_tables(code, device="cpu")
    args = port(c)
    assert_exact(tbp.decode_blocks_device(*args[:3], tables, 20), want, "port vs JAX")


@pytest.mark.parametrize("name", ["intra", "video mv", "video residual 0", "video residual 1",
                                  "video residual 2"])
def test_plain_walk_matches_jax_on_codec_streams(codec_walks, name):
    call = codec_walks[name]
    assert call["words"].device.type == "cpu"
    c = as_numpy(call)
    plain = tbp.decode_blocks_device_plain(*port(c))
    assert_exact(plain, jax_walk(c), f"{name} walk")
    args = (call["words"], call["offsets"], call["counts"], call["tables"], call["max_syms"])
    assert_exact(tbp.decode_blocks_device(*args), plain, f"{name} dispatch")
    assert_exact(tbp.decode_blocks_device(*args, max_count=call["max_count"]), plain,
                 f"{name} at the caller's depth")
    counts = c["counts"]
    assert plain.shape == (counts.shape[0], c["max_syms"]) and counts.max() > 0
    past = np.arange(c["max_syms"])[None, :] >= counts[:, None]
    assert not plain.numpy()[past].any(), "nonzero past a block's count"


@pytest.mark.parametrize("case", sorted(CORRUPT, key=str), ids=str)
def test_plain_walk_matches_jax_on_corrupt_streams(case):
    c = corrupt_streams(*case)
    want, seen, bits = scalar_walk(c)
    missing = (CORRUPT[case] | EVERY_CASE) - seen
    assert not missing, f"the streams never met {missing}"
    assert_exact(jax_walk(c), want, "JAX walk vs scalar walk")
    got, got_bits = tbp.decode_blocks_device_plain(*port(c), return_bits=True)
    assert_exact(got, want, "plain walk vs scalar walk")
    assert_exact(got_bits, bits, "bits walked")


def test_plain_walk_refuses_tables_it_does_not_take():
    words, offs, counts, tables, max_syms = port(corrupt_streams("random", 1, 300, 40, B=8))
    lj, fc, go, ss, min_len, max_len = tables
    for bad, match in (((lj, fc, go, ss, min_len, 0), "max_len"),
                       ((lj, fc, go, ss, min_len, 33), "max_len"),
                       ((lj, fc[:32], go, ss, min_len, max_len), "33 entries"),
                       ((lj, fc, go, ss, -1, max_len), "min_len"),
                       ((lj, fc, go, ss[:0], min_len, max_len), "empty")):
        with pytest.raises(ValueError, match=match):
            tbp.decode_blocks_device_plain(words, offs, counts, bad, max_syms)
    with pytest.raises(ValueError, match="empty stream"):
        tbp.decode_blocks_device_plain(words[:0], offs, counts, tables, max_syms)


def test_cuda_wrapper_refuses_cpu_tensors():
    """On the CPU the dispatcher walks the plain loop; the kernel's wrapper
    takes only CUDA tensors and counts no launch when it refuses."""
    args = port(corrupt_streams("random", 1, 300, 40, B=64))
    before = tbp.CANON_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tbp.decode_blocks_device_cuda(*args)
    assert tbp.CANON_LAUNCHES == before
    assert_exact(tbp.decode_blocks_device(*args), tbp.decode_blocks_device_plain(*args),
                 "dispatch")
    assert tbp.CANON_LAUNCHES == before


def test_canon_walk_bound_counts_each_sector_once():
    """Sectors of 4 int64 words: blocks that share a sector pay for it once,
    blocks that walk no bit pay only their offset, count and output row."""
    # words 0-1, 1-2 (sector 0), 6-9 (sectors 1, 2), 156 (sector 39), none
    ms, by = canon_walk_bound([0, 40, 200, 5000, 64], [40, 40, 100, 10, 0], 200, 4)
    assert by == "bytes"
    assert ms == pytest.approx((4 * 32 + 5 * (8 + 4 * 4)) / 3.35e12 * 1e3)
    # offsets past the stream read its last word's sector
    ms, _ = canon_walk_bound([900], [3], 10, 1)
    assert ms == pytest.approx((32 + 12) / 3.35e12 * 1e3)


# adversarial bound tables for the prefix table: (kind, min_len, max_len)
ADVERSARIAL = [("unsorted", 1, 32), ("duplicate", 1, 32), ("wild", 20, 16), ("inside", 0, 1),
               ("clustered", 1, 32), ("edges", 3, 12), ("clustered", 20, 1), ("inside", 9, 32)]


def adversarial_streams(kind, min_len, max_len, B=512) -> dict:
    seed = 700 + 7 * min_len + max_len + tbp.PREFIX_BITS
    return fixtures.canon_walk_streams(seed=seed, B=B, min_len=min_len, max_len=max_len,
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
@pytest.mark.parametrize("table", ["intra", "video mv", "video residual 0", "skewed",
                                   "laplacian", "random"] + [f"{k} {m}" for k, _, m in ADVERSARIAL])
def test_prefix_table_counts_as_the_compares(codec_walks, table, bits):
    """``prefix_table`` + ``prefix_count`` (the kernels' rule) against the
    weighted compare count (the last bound weighing 32 - ``max_len``), at
    both ends of every prefix's range, at each bound and its neighbours and
    on random windows: the real canonical codes of the intra and adaptive
    decoders, the fixture's codes, and the adversarial tables at their
    ``max_len``."""
    if table in codec_walks:
        lj, _, _, _, _, max_len = codec_walks[table]["tables"]
        c = {"lj": lj.numpy(), "max_len": max_len}
    elif table in ("skewed", "laplacian", "random"):
        c = corrupt_streams(table, None if table != "random" else 1,
                            9000 if table == "laplacian" else None, 40)
    else:
        kind, max_len = table.split()
        c = {"lj": fixtures.prefix_bounds(kind, 19, n=32, bits=bits), "max_len": int(max_len)}
    bounds, weights = canon_bounds(c)
    v, w = torch.tensor(bounds), torch.tensor(weights)
    t = tbp.prefix_table(v, w, bits)
    win = torch.from_numpy(window_probes(bounds, bits, 5))
    want = ((win[:, None] > v[None, :]) * w[None, :]).sum(dim=1)
    assert_exact(tbp.prefix_count(win, t), want, f"{table} counts")


@pytest.mark.parametrize("case", [("corrupt",) + k for k in sorted(CORRUPT, key=str)]
                         + ADVERSARIAL, ids=str)
def test_table_walk_matches_plain_walk(case):
    """A scalar walk that counts by the prefix table, in the kernels' order
    (the table's entry, else compares against the prefix's inner bounds),
    equals ``decode_blocks_device_plain`` on the corrupt fixtures and on the
    adversarial tables: unsorted, repeated, negative and >= 2^32 bounds
    (taken modulo 2^32), bounds inside prefixes and at their edges,
    ``max_len`` 1, 12, 16 and 32, ``min_len`` 0 to 20."""
    c = corrupt_streams(*case[1:]) if case[0] == "corrupt" else adversarial_streams(*case)
    want, _, bits = scalar_walk(c, table_count(*canon_bounds(c)))
    got, got_bits = tbp.decode_blocks_device_plain(*port(c), return_bits=True)
    assert_exact(got, want, f"plain walk vs table walk ({case})")
    assert_exact(got_bits, bits, "bits walked")


# the kernel on the card: every corrupt case, a partial last CTA, the
# adversarial tables, and the codec streams
@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CORRUPT, key=str) + ADVERSARIAL, ids=str)
def test_kernel_matches_plain_walk_on_corrupt_streams(cuda_device, case):
    c = adversarial_streams(*case, B=333) if case in ADVERSARIAL else corrupt_streams(*case, B=333)
    args = port(c, cuda_device)
    before = tbp.CANON_LAUNCHES
    got = tbp.decode_blocks_device(*args)
    torch.cuda.synchronize()
    assert tbp.CANON_LAUNCHES == before + 1
    assert_exact(got, tbp.decode_blocks_device_plain(*args), f"kernel vs plain ({case})")


@pytest.mark.cuda
def test_kernel_matches_plain_walk_on_codec_streams(cuda_device, monkeypatch):
    walks = captured_canon_walks(monkeypatch, cuda_device)
    for name, call in walks.items():
        assert call["words"].is_cuda
        args = (call["words"], call["offsets"], call["counts"], call["tables"],
                call["max_syms"])
        assert_exact(tbp.decode_blocks_device_cuda(*args),
                     tbp.decode_blocks_device_plain(*args), f"kernel vs plain ({name})")
    words, offs, counts, tables, max_syms = args
    assert tbp.decode_blocks_device_cuda(words, offs[:0], counts[:0], tables,
                                         max_syms).shape == (0, max_syms)
    assert tbp.decode_blocks_device_cuda(words, offs, counts, tables, 0).shape == (offs.shape[0], 0)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    words, offs, counts, tables, max_syms = port(corrupt_streams("random", 1, 300, 40, B=64),
                                                 cuda_device)
    lj, fc, go, ss, min_len, max_len = tables
    before = tbp.CANON_LAUNCHES
    for bad in ((words, offs, counts, (lj, fc, go, ss, min_len, 0), max_syms),
                (words, offs, counts, (lj, fc, go, ss, 33, max_len), max_syms),
                (words, offs.cpu(), counts, tables, max_syms),
                (words, offs, counts[:-1], tables, max_syms),
                (words[:0], offs, counts, tables, max_syms)):
        with pytest.raises(ValueError):
            tbp.decode_blocks_device_cuda(*bad)
    assert tbp.CANON_LAUNCHES == before
