"""The grouped packer (``ivclab_tpu_torch/ops/bitpack.py``).

On the CPU: the plain packer (``pack_codes_grouped_dense_plain``, what
``pack_codes_grouped_dense`` runs for CPU tensors) against JAX's
``pack_codes_grouped_dense2`` exactly where the buckets do not hold the
content: blocks past ``block_words``, groups past ``words_per_group``,
placements that wrap the power-of-two arena, and coded slots at or past
the most coded slots of any block (the slot limit). Each case checks that
its edge occurs. Also the dispatch for CPU tensors and
``utils/timing.py::grouped_pack_bound``.

On a card (``cuda``; skipped elsewhere): the Hopper kernel
(``csrc/grouped_pack.cu``) against the plain packer, every output bit for
bit, at the three codecs' shapes and on the same edge cases; its counters;
the codecs' packs going through it; its refusals. JAX is imported only by
the CPU parity test, so the card's cases run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_exact, cuda_device  # noqa: F401

import ivclab_tpu_torch.ops.bitpack as tbp
from ivclab_tpu_torch.runtime import trace
from ivclab_tpu_torch.utils.timing import H100_HBM_BYTES_PER_S, grouped_pack_bound


def make_slots(seed: int, N: int, S: int, kind: str):
    """Seeded ``[N, S]`` int64 codes below 2^32 and int32 lengths:
    ``dense`` lengths 1-32 in every slot; ``holes`` 0-32 with about half
    the slots uncoded, between coded ones; ``left`` each block coding its
    first slots only, mostly few (the codecs' blocks); ``full32`` every slot
    a 32-bit code; ``zero`` no slot coded."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**32, (N, S), dtype=np.int64)
    if kind == "dense":
        lens = rng.integers(1, 33, (N, S))
    elif kind == "holes":
        lens = rng.integers(0, 33, (N, S)) * (rng.random((N, S)) < 0.5)
    elif kind == "left":
        counts = np.minimum(rng.geometric(0.2, N) - 1, S)
        counts[rng.random(N) < 0.01] = S  # a few full blocks, as a noise corner gives
        lens = np.where(np.arange(S)[None, :] < counts[:, None], rng.integers(2, 17, (N, S)), 0)
    elif kind == "full32":
        codes[0, :4] = [0, 1, 2**31, 2**32 - 1]
        lens = np.full((N, S), 32)
    elif kind == "zero":
        lens = np.zeros((N, S))
    else:
        raise ValueError(kind)
    return torch.from_numpy(codes), torch.from_numpy(lens.astype(np.int32))


def edges(lens: torch.Tensor, gs: int, wpg: int, bw: int) -> set:
    """Which of the plain packer's edge rules the lengths exercise."""
    lens = lens.to(torch.int64)
    block_bits = lens.sum(dim=1)
    group_bits = block_bits.reshape(-1, gs).sum(dim=1)
    O = block_bits.reshape(-1, gs).cumsum(dim=1) - block_bits.reshape(-1, gs)
    pad_w = tbp._next_pow2(wpg + bw + 2)
    coded = lens > 0
    limit = int(coded.sum(dim=1).max())
    found = set()
    if bool((block_bits > 32 * bw).any()):
        found.add("block overflow")
    if bool((group_bits > 32 * wpg).any()):
        found.add("group overflow")
    # a block's word placed past the arena's end, landing inside the group
    first = (O >> 5).reshape(-1).tolist()
    n_words = torch.clamp((block_bits + 31) >> 5, max=bw).tolist()
    if any(k >= pad_w and k % pad_w < wpg
           for p, n in zip(first, n_words) for k in range(p, p + n + 1)):
        found.add("arena wrap")
    if bool(coded[:, limit:].any()):
        found.add("slot limit")
    return found


# (kind, N, S, group_size, words_per_group, block_words, the edges it must hit)
EDGE_CASES = [
    ("dense", 64, 24, 16, 256, 4, {"block overflow"}),
    ("dense", 64, 24, 16, 32, 32, {"group overflow"}),
    ("dense", 32, 40, 16, 16, 64, {"group overflow", "arena wrap"}),
    ("holes", 64, 40, 16, 1600, 128, {"slot limit"}),
    ("holes", 48, 40, 16, 24, 8, {"slot limit", "block overflow", "group overflow"}),
    ("full32", 32, 8, 16, 128, 8, set()),
    ("zero", 32, 16, 16, 64, 8, set()),
    ("left", 16, 128, 16, 64, 16, set()),
]
EDGE_IDS = [f"{k}-N{n}-S{s}-wpg{w}-bw{b}" for k, n, s, _, w, b, _ in EDGE_CASES]


@pytest.mark.parametrize("kind,N,S,gs,wpg,bw,want", EDGE_CASES, ids=EDGE_IDS)
def test_plain_equals_jax_past_the_buckets(kind, N, S, gs, wpg, bw, want):
    import ivclab_tpu.ops.bitpack as jbp

    codes, lens = make_slots(len(kind) * 1000 + N + S + wpg, N, S, kind)
    assert want <= edges(lens, gs, wpg, bw)
    got = tbp.pack_codes_grouped_dense_plain(codes, lens, gs, wpg, bw)
    ref = jbp.pack_codes_grouped_dense2(codes.numpy().astype(np.uint32), lens.numpy(), gs, wpg,
                                        bw)
    for what, g, r in zip(("words", "group bits", "block offsets"), got, ref):
        assert_exact(g, np.asarray(r), f"{what} ({kind}, wpg {wpg}, bw {bw})")


def test_cpu_tensors_take_the_plain_packer():
    codes, lens = make_slots(3, 64, 40, "holes")
    before = tbp.PACK_LAUNCHES
    trace.enable()
    try:
        got = tbp.pack_codes_grouped_dense(codes, lens, 16, 24, 8)
        counts = trace.summary()["counts"]
    finally:
        trace.disable()
        trace.reset()
    assert tbp.PACK_LAUNCHES == before and "pack_kernel" not in counts
    for g, w in zip(got, tbp.pack_codes_grouped_dense_plain(codes, lens, 16, 24, 8)):
        assert_exact(g, w, "dispatch on the CPU")


@pytest.mark.parametrize("N,S,G,wpg,len_bytes,want_bytes", [
    (261_120, 128, 16_320, 1024, 4, 261_120 * 128 * 12 + 16_320 * 1024 * 8 + 261_120 * 4
     + 16_320 * 4),
    (32_640, 64, 2_040, 128, 8, 32_640 * 64 * 16 + 2_040 * 128 * 8 + 32_640 * 4 + 2_040 * 4),
    (16, 1, 1, 1, 4, 16 * 12 + 8 + 16 * 4 + 4),
])
def test_grouped_pack_bound_counts_each_byte_once(N, S, G, wpg, len_bytes, want_bytes):
    ms, by = grouped_pack_bound(N, S, G, wpg, len_bytes)
    assert by == "bytes"
    assert ms == pytest.approx(want_bytes / H100_HBM_BYTES_PER_S * 1e3, rel=1e-12)
    if (N, wpg) == (261_120, 1024):
        assert 0.159 < ms < 0.161  # the 1080p GOP's deposit at wpg 1024


# ----------------------------------------------------------------- the card


def on_card(dev, codes, lens, dtype=torch.int32):
    return codes.to(dev), lens.to(dev, dtype)


def assert_kernel_equals_plain(args, what: str):
    before = tbp.PACK_LAUNCHES
    got = tbp.pack_codes_grouped_dense(*args)
    torch.cuda.synchronize()
    assert tbp.PACK_LAUNCHES == before + 1
    want = tbp.pack_codes_grouped_dense_plain(*args)
    for name, g, w in zip(("words", "group bits", "block offsets"), got, want):
        assert g.dtype == w.dtype and g.is_cuda, f"{name} ({what})"
        assert_exact(g, w, f"{name} ({what})")


# (what, N, S, words_per_group, block_words, length dtype): the GOP codec's
# 1080p deposit at two bucket pairs, the adaptive codec's frame at its
# speculative buckets and at full stride, the intra codec's 1088x1920 RGB
CALLER_SHAPES = [
    ("fused 1080p GOP", 261_120, 128, 1024, 64, torch.int32),
    ("fused 1080p GOP, widest buckets", 261_120, 128, 2048, 128, torch.int32),
    ("adaptive frame, speculative", 32_640, 64, 128, 32, torch.int64),
    ("adaptive frame, full stride", 32_640, 128, 1600, 128, torch.int64),
    ("intra 1088x1920 RGB", 97_920, 128, 1600, 128, torch.int64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("what,N,S,wpg,bw,dtype", CALLER_SHAPES, ids=[c[0] for c in CALLER_SHAPES])
def test_kernel_equals_plain_at_the_callers_shapes(cuda_device, what, N, S, wpg, bw, dtype):
    codes, lens = on_card(cuda_device, *make_slots(N + wpg, N, S, "left"), dtype)
    assert_kernel_equals_plain((codes, lens, 16, wpg, bw), what)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,S,gs,wpg,bw,want", EDGE_CASES, ids=EDGE_IDS)
def test_kernel_equals_plain_past_the_buckets(cuda_device, kind, N, S, gs, wpg, bw, want):
    codes, lens = make_slots(len(kind) * 1000 + N + S + wpg, N, S, kind)
    for dtype in (torch.int32, torch.int64):
        assert_kernel_equals_plain((*on_card(cuda_device, codes, lens, dtype), gs, wpg, bw),
                                   f"{kind}, {dtype}")


# random lengths 0-32 with holes at shapes the codecs do not use: several
# tiles a block, a partial tile, groups of 8 and 48 blocks, odd group
# widths, the widest group the kernel takes (one warp a CTA), one group
RANDOM_SHAPES = [
    (4096, 128, 16, 1600, 128), (4096, 200, 16, 1024, 64), (2048, 37, 16, 64, 8),
    (1024, 96, 8, 100, 16), (960, 64, 48, 511, 32), (64, 64, 16, tbp.PACK_MAX_GROUP_WORDS, 128),
    (16, 128, 16, 1601, 128), (16, 1, 16, 1, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("N,S,gs,wpg,bw", RANDOM_SHAPES, ids=str)
def test_kernel_equals_plain_on_random_lengths(cuda_device, N, S, gs, wpg, bw):
    for kind in ("holes", "dense", "zero"):
        codes, lens = make_slots(N * S + gs, N, S, kind)
        assert_kernel_equals_plain((*on_card(cuda_device, codes, lens), gs, wpg, bw),
                                   f"{kind} {N}x{S}")


@pytest.mark.cuda
def test_each_launch_is_counted(cuda_device):
    codes, lens = on_card(cuda_device, *make_slots(5, 256, 64, "left"))
    before = tbp.PACK_LAUNCHES
    trace.enable()
    try:
        with trace.span("outer"):
            for _ in range(3):
                tbp.pack_codes_grouped_dense(codes, lens, 16, 128, 32)
        summary = trace.summary()
    finally:
        trace.disable()
        trace.reset()
    assert tbp.PACK_LAUNCHES == before + 3
    assert summary["counts"]["pack_kernel"] == 3


@pytest.mark.cuda
def test_the_codecs_pack_through_the_kernel(cuda_device):
    from ivclab_tpu_torch import FusedVideoCodec, IntraCodec, VideoCodec
    from ivclab_tpu_torch.utils import fixtures

    y = np.ascontiguousarray(fixtures.video("bench", 8, (128, 256)).astype(np.float32).mean(-1))
    fused = FusedVideoCodec(1.0, device=cuda_device).train(y[:2])
    qsyms, *_ = fused.encode_gop(torch.from_numpy(y).to(cuda_device))
    before = tbp.PACK_LAUNCHES
    p = fused.pack_gop(qsyms, check=False)
    torch.cuda.synchronize()
    assert tbp.PACK_LAUNCHES == before + 1 and bool(p.ok)

    before = tbp.PACK_LAUNCHES
    blob = VideoCodec(1.0, device=cuda_device).encode_to_container(y)
    assert tbp.PACK_LAUNCHES - before >= 8  # a frame each, and a full-stride re-pack where needed
    assert blob == VideoCodec(1.0, device="cpu").encode_to_container(y)

    img = np.ascontiguousarray(fixtures.image("lena")[:128, :256])
    intra, intra_cpu = IntraCodec(1.0, device=cuda_device), IntraCodec(1.0, device="cpu")
    intra.train_huffman_from_image(img)
    intra_cpu.train_huffman_from_image(img)
    before = tbp.PACK_LAUNCHES
    blob = intra.encode_to_container(img)
    assert tbp.PACK_LAUNCHES == before + 1
    assert blob == intra_cpu.encode_to_container(img)


@pytest.mark.cuda
def test_the_kernel_refuses_what_it_does_not_take(cuda_device):
    codes, lens = on_card(cuda_device, *make_slots(7, 64, 32, "left"))
    before = tbp.PACK_LAUNCHES
    for bad in ((codes.cpu(), lens, 16, 64, 8), (codes, lens.cpu(), 16, 64, 8),
                (codes.double(), lens, 16, 64, 8), (codes, lens.float(), 16, 64, 8),
                (codes, lens.bool(), 16, 64, 8), (codes[:, :-1], lens, 16, 64, 8),
                (codes.reshape(-1), lens.reshape(-1), 16, 64, 8), (codes[:-1], lens[:-1], 16, 64, 8),
                (codes[:0], lens[:0], 16, 64, 8), (codes[:, :0], lens[:, :0], 16, 64, 8),
                (codes, lens, 0, 64, 8), (codes, lens, 16, 0, 8), (codes, lens, 16, 64, 0),
                (codes, lens, 16, tbp.PACK_MAX_GROUP_WORDS + 1, 8)):
        with pytest.raises(ValueError):
            tbp.pack_codes_grouped_dense_cuda(*bad)
    assert tbp.PACK_LAUNCHES == before
