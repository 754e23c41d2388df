"""Parity of the port's host entropy side with the JAX package.

The C++ engine (``ivclab_tpu_torch/csrc/entropy.cpp`` via
``runtime/native.py``), its numpy versions and the JAX package's engine
give equal outputs on seeded inputs; ``HuffmanCoder`` gives JAX's codes,
words and decodes; the statistics, colour transforms, metrics and fixture
images match. The engine's first build is race-free across processes, a
failed compile raises with g++'s stderr, and only a missing g++ takes the
numpy path. Integers are compared exactly; each float comparison states
its tolerance.
"""

import ctypes
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import assert_close, assert_exact

import jax.numpy as jnp

import ivclab_tpu.entropy.stats as jstats
import ivclab_tpu.ops.color as jcolor
import ivclab_tpu.runtime.native as jnative
import ivclab_tpu.utils.metrics as jmetrics
from ivclab_tpu.entropy.codebook import huffman_code_lengths as j_code_lengths
from ivclab_tpu.entropy.codebook import limit_code_lengths as j_limit_lengths
from ivclab_tpu.entropy.huffman import HuffmanCoder as JHuffman
from ivclab_tpu.models import IntraCodec as JIntra
from ivclab_tpu.utils import fixtures as jfix

import ivclab_tpu_torch.entropy.codebook as tcb
import ivclab_tpu_torch.entropy.stats as tstats
import ivclab_tpu_torch.ops.color as tcolor
import ivclab_tpu_torch.utils.metrics as tmetrics
from ivclab_tpu_torch import HuffmanCoder as THuffman
from ivclab_tpu_torch import IntraCodec as TIntra
from ivclab_tpu_torch.runtime import cuda_build, native as tnative
from ivclab_tpu_torch.utils import fixtures as tfix

ROOT = Path(__file__).resolve().parents[1]


def _pmfs():
    rng = np.random.default_rng(31)
    lap = np.exp(-np.abs(np.arange(401) - 200) / 9.0) + 1e-9
    counts = rng.integers(0, 40, 300).astype(np.float64) + 1e-9
    skew = 2.0 ** -np.arange(45)  # depths reach 44 before the length limit
    ties = np.repeat([1.0, 2.0, 3.0, 5.0], 16)  # equal weights everywhere
    return {
        "laplacian": lap / lap.sum(),
        "counts": counts / counts.sum(),
        "skewed": skew / skew.sum(),
        "ties": ties / ties.sum(),
        "two": np.array([0.25, 0.75]),
    }


# ------------------------------------------------------------ native engine


def test_engine_builds_from_the_port_source():
    assert tnative.available(), tnative.unavailable_reason()
    assert tnative.unavailable_reason() is None
    path, _ = cuda_build.build_host()
    assert path.parent == cuda_build.CSRC / "_build"
    assert path.name.startswith("entropy_") and path.exists()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_bits_matches_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    lens = rng.integers(0, 33, n).astype(np.int32)
    lens[rng.random(n) < 0.1] = 0
    codes = (rng.integers(0, 2**32, n, dtype=np.uint64) & ((1 << lens.astype(np.uint64)) - 1)
             ).astype(np.uint32)
    words, total = tnative.pack_bits(codes, lens)
    jwords, jtotal = jnative.pack_bits(codes, lens)
    out = np.zeros(words.size + 1, dtype=np.uint32)
    assert total == jtotal == tnative._pack_bits_np(codes, lens, out) == int(lens.sum())
    assert_exact(words, jwords, "words vs JAX engine")
    assert_exact(words, out[: words.size], "words vs numpy")


@pytest.mark.parametrize("name", ["laplacian", "counts", "skewed"])
def test_decode_symbols_matches_numpy_and_jax(name):
    pmf = _pmfs()[name]
    code = tcb.build_canonical_code(pmf, lower_bound=-3, max_len=32)
    rng = np.random.default_rng(5)
    idx = rng.choice(pmf.size, 2500, p=pmf)
    words, total = tnative.pack_bits(code.codes[idx], code.lengths[idx])
    got = tnative.decode_symbols(words, idx.size, code)
    assert_exact(got, idx, "C++ decode")
    assert_exact(tnative._decode_symbols_np(words, idx.size, code.lj_next_minus1, code.first_code,
                                            code.group_offset, code.sorted_syms, 0, code.min_len),
                 idx, "numpy decode")
    assert_exact(jnative.decode_symbols(words, idx.size, code), idx, "JAX engine decode")
    with pytest.raises(ValueError):
        tnative.decode_symbols(words[:2], idx.size, code)


@pytest.mark.parametrize("name", list(_pmfs()))
def test_huffman_depths_match_the_numpy_loop_and_jax(name):
    pmf = _pmfs()[name]
    leaf = np.sort(pmf, kind="stable")
    assert_exact(tnative.huffman_depths(leaf), tcb._huffman_depths_np(leaf), "C++ vs numpy")
    assert_exact(tnative.huffman_depths(leaf), jnative.huffman_depths(leaf), "C++ vs JAX engine")
    order = np.argsort(pmf, kind="stable")
    numpy_lengths = np.empty(pmf.size, dtype=np.int32)
    numpy_lengths[order] = tcb._huffman_depths_np(pmf[order])
    assert_exact(tcb.huffman_code_lengths(pmf), numpy_lengths, "native path vs numpy loop")
    assert_exact(tcb.huffman_code_lengths(pmf), j_code_lengths(pmf), "port vs JAX lengths")


def _residual_pmf(bins: int, seed: int) -> np.ndarray:
    """A frame's smoothed training pmf: a Laplacian residual histogram over
    the alphabet ``[4001 - bins, 4000]`` and 32,640 end-of-block symbols at
    its top bin (EOB 4000), as the adaptive codec's bucketed alphabets hold."""
    rng = np.random.default_rng(seed)
    vals = np.arange(4001 - bins, 4001)
    hist = np.round(rng.uniform(1e3, 1e5) * np.exp(-np.abs(vals) / rng.uniform(1.5, 12.0)))
    hist[-1] += 32640
    return tstats.pmf_from_histogram(hist.astype(np.int64)).astype(np.float64)


def _limit_cases():
    cases = [pytest.param(_residual_pmf(bins, bins), max_len, id=f"residual{bins}-{max_len}")
             for bins in (4096, 4416, 6144, 8256) for max_len in (16, 26, 32)]
    cases += [pytest.param(_pmfs()["skewed"], max_len, id=f"skewed-{max_len}")
              for max_len in (16, 26, 32)]
    return cases + [pytest.param(_pmfs()["ties"], 26, id="within"),
                    pytest.param(np.ones(1), 26, id="one"),
                    pytest.param(_pmfs()["two"], 1, id="two")]


@pytest.mark.parametrize("pmf,max_len", _limit_cases())
def test_limit_lengths_match_the_numpy_loop_and_jax(pmf, max_len, monkeypatch):
    lengths = tcb.huffman_code_lengths(pmf)
    limited = tcb.limit_code_lengths(lengths, max_len)
    assert_exact(limited, j_limit_lengths(lengths, max_len), "C++ path vs JAX lengths")
    with monkeypatch.context() as m:
        m.setattr(tnative, "limit_bits", lambda bits, max_len: None)
        assert_exact(tcb.limit_code_lengths(lengths, max_len), limited, "numpy loop vs C++ path")
    assert limited.max() <= max_len
    assert limited.size < 2 or np.sum(2.0 ** -limited) == 1.0  # Kraft equality
    top = int(lengths.max())
    if top <= max_len:
        assert_exact(limited, lengths, "within the limit: unchanged")
        return
    bits = np.bincount(lengths, minlength=top + 1).astype(np.int64)
    bits_np = bits.copy()
    moves = tnative.limit_bits(bits, max_len)
    assert moves == tcb._limit_bits_np(bits_np, max_len) > 0
    assert_exact(bits, bits_np, "C++ vs numpy histogram")
    assert bits[max_len + 1:].sum() == 0


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_more_symbols_than_the_limit_holds_are_refused(path, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(tnative, "limit_bits", lambda bits, max_len: None)
    lengths = tcb.huffman_code_lengths(np.full(17, 1 / 17))  # 17 codes, 2**4 = 16
    with pytest.raises(ValueError):
        tcb.limit_code_lengths(lengths, 4)
    sixteen = tcb.huffman_code_lengths(2.0 ** -np.arange(16))
    assert_exact(tcb.limit_code_lengths(sixteen, 4), np.full(16, 4), "2**4 codes of 4 bits")
    # the loop itself, past the up-front check: no leaf is left to split
    bits = np.bincount(lengths).astype(np.int64)
    limit = tnative.limit_bits if path == "native" else tcb._limit_bits_np
    with pytest.raises(ValueError):
        limit(bits, 4)


def test_zerorun_oracles_match_jax():
    rng = np.random.default_rng(9)
    blocks = np.round(rng.laplace(0, 3, (200, 64)) * np.exp(-np.arange(64) / 10)).astype(np.int32)
    blocks[rng.random(blocks.shape) < 0.6] = 0
    stream = tnative.zerorun_encode(blocks, 4000)
    assert_exact(stream, jnative.zerorun_encode(blocks, 4000), "zero-run encode")
    assert_exact(tnative.zerorun_decode(stream, 200, 64, 4000), blocks, "zero-run decode")
    with pytest.raises(ValueError):
        tnative.zerorun_decode(stream[:-1], 200, 64, 4000)


_BUILDER = textwrap.dedent("""
    import ctypes, sys, time
    from pathlib import Path
    sys.path.insert(0, sys.argv[1])
    from ivclab_tpu_torch.runtime import cuda_build
    build, gate = Path(sys.argv[2]), Path(sys.argv[3])
    (gate / f"ready.{sys.argv[4]}").touch()
    deadline = time.monotonic() + 60
    while not (gate / "go").exists():
        if time.monotonic() > deadline:
            sys.exit("no go signal")
        time.sleep(0.005)
    path, _ = cuda_build.build_host(cuda_build.CSRC / "entropy.cpp", build)
    lib = ctypes.CDLL(str(path))
    lib.ivc_huffman_depths.restype = ctypes.c_int64
    print(path)
""")


def test_four_concurrent_first_builds_all_load(tmp_path):
    build, gate = tmp_path / "_build", tmp_path / "gate"
    gate.mkdir()
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(ROOT), str(build), str(gate),
                               str(k)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k in range(4)]
    try:
        deadline = time.monotonic() + 90
        while len(list(gate.glob("ready.*"))) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        (gate / "go").touch()  # all four start their first build together
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    want = cuda_build._hashed(cuda_build.CSRC / "entropy.cpp", cuda_build.HOST_FLAGS, build)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == str(want)
    assert sorted(f.name for f in build.iterdir()) == sorted([want.name, f"{want.name}.lock"])
    ctypes.CDLL(str(want))


def test_failed_compile_raises_with_stderr(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int f() { return undeclared_name; }\n')
    with pytest.raises(RuntimeError, match="undeclared_name"):
        cuda_build.build_host(bad, tmp_path / "_build")
    # neither a library nor the temporary compiler output is left behind
    assert [p.suffix for p in (tmp_path / "_build").iterdir()] == [".lock"]


def test_missing_compiler_takes_the_numpy_path(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ here
    lib, reason = tnative._load(tmp_path / "_build")
    assert lib is None and "g++" in reason
    with pytest.raises(FileNotFoundError):
        cuda_build.build_host(cuda_build.CSRC / "entropy.cpp", tmp_path / "_build")


# ------------------------------------------------------------ HuffmanCoder


@pytest.mark.parametrize("name", ["laplacian", "counts", "skewed", "ties", "two"])
def test_huffman_coder_matches_jax(name):
    pmf = _pmfs()[name]
    t = THuffman(lower_bound=-7).train(pmf)
    j = JHuffman(lower_bound=-7).train(pmf)
    for field in ("lengths", "codes", "lj_next_minus1", "first_code", "group_offset",
                  "sorted_syms"):
        assert_exact(getattr(t.code, field), getattr(j.code, field), field)
    assert t.code.min_len == j.code.min_len
    rng = np.random.default_rng(11)
    msg = rng.choice(pmf.size, 1500, p=pmf) - 7
    words, bits = t.encode(msg)
    jwords, jbits = j.encode(msg)
    assert bits == jbits
    assert_exact(words, jwords, "words")
    assert_exact(t.decode(words, msg.size), msg, "decode")
    assert t.is_prefix_free() and j.is_prefix_free()
    assert all(t.get_code(i) == j.get_code(i) for i in range(min(pmf.size, 40)))
    assert t.mean_code_length() == pytest.approx(j.mean_code_length(), rel=1e-12)
    assert t.probs is t.pmf


def test_huffman_coder_errors():
    with pytest.raises(ValueError, match="Zero-probability"):
        THuffman().train([0.5, 0.0, 0.5])
    with pytest.raises(RuntimeError, match="Train"):
        THuffman().encode([1, 2])
    with pytest.raises(RuntimeError, match="Train"):
        THuffman().decode(np.zeros(2, np.uint32), 3)
    coder = THuffman(lower_bound=2).train([0.5, 0.25, 0.25])
    with pytest.raises(ValueError, match="outside the trained range"):
        coder.encode([2, 5])
    with pytest.raises(ValueError, match="outside the trained range"):
        coder.encode([1])


# ------------------------------------------------ codec code lengths vs JAX


@pytest.mark.parametrize("name", ["lena_small", "lena", "sail", "monarch"])
def test_trained_code_lengths_equal_jax(name):
    """The float32 pmf, and with it the Huffman tree, is built as JAX builds
    it, so each side training on its own gives the same code."""
    img = jfix.image(name)
    for q in (0.15, 0.5, 1.0, 2.0):
        j, t = JIntra(q), TIntra(q, device="cpu")
        j.train_huffman_from_image(img)
        t.train_huffman_from_image(img)
        assert t.bounds == j.bounds, (name, q)
        assert_exact(t.huffman.pmf, np.asarray(j.huffman.pmf), f"{name} q={q} pmf")
        assert_exact(t.huffman.code.lengths, j.huffman.code.lengths, f"{name} q={q} lengths")


# ------------------------------------------------------------ statistics


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 100, 1000, 1472, 4159, 70001])
def test_pmf_sum_order_matches_jax(n):
    p = np.random.default_rng(n).random(n).astype(np.float32) * np.float32(1e-3)
    assert tstats._sum_f32(p) == np.asarray(jnp.sum(jnp.asarray(p)))
    hist = np.random.default_rng(n + 1).integers(0, 50, n)
    hist[0] += 1
    want = jstats.smooth_pmf(jnp.asarray(hist).astype(jnp.float32) / jnp.sum(jnp.asarray(hist)))
    assert_exact(tstats.pmf_from_histogram(hist).view(np.int32),
                 np.asarray(want).view(np.int32), "pmf bits")
    assert_exact(tstats.smooth_pmf(p).view(np.int32), np.asarray(jstats.smooth_pmf(p)).view(np.int32),
                 "smooth_pmf bits")


def test_stats_match_jax(lena_small):
    img = lena_small
    gray = img[:, :, 0]
    edges = np.arange(0, 257)
    assert_exact(tstats.stats_marg(img, edges).numpy().view(np.int32),
                 np.asarray(jstats.stats_marg(img, edges)).view(np.int32), "stats_marg")
    assert_exact(tstats.stats_joint(img, edges).numpy().view(np.int32),
                 np.asarray(jstats.stats_joint(img, edges)).view(np.int32), "stats_joint")
    assert tuple(tstats.stats_joint(gray, edges, to_flat=False).shape) == (257, 257)
    pmf = np.asarray(jstats.stats_marg(img, edges))
    other = np.asarray(jstats.stats_marg(jfix.image("sail"), edges))
    # float32 sums of log terms in another order: relative 1e-5
    assert_close(tstats.calc_entropy(pmf), jstats.calc_entropy(pmf), 1e-5 * 8, "entropy")
    assert_close(tstats.min_code_length(pmf, other), jstats.min_code_length(pmf, other),
                 1e-5 * 10, "min_code_length")
    assert_close(tstats.stats_cond(gray, edges), jstats.stats_cond(gray, edges), 1e-5 * 8,
                 "stats_cond")
    for t, j in zip(tstats.basic_histo(img), jstats.basic_histo(img)):
        assert_exact(t, j, "basic_histo rgb")
    assert_exact(tstats.basic_histo(gray), jstats.basic_histo(gray), "basic_histo gray")
    with pytest.raises(ValueError):
        tstats.basic_histo(np.zeros((4, 4, 2)))
    assert tstats.count_rgb_histogram(img[:64, :64]) == jstats.count_rgb_histogram(img[:64, :64])
    assert_exact(tstats.count_rgb_histogram(img, grayscale=True),
                 jstats.count_rgb_histogram(img, grayscale=True), "gray histogram")


# ------------------------------------------------- colour, metrics, fixtures


@pytest.mark.parametrize("shape", [(256, 256), (45, 61), (41, 57)])
def test_color_matches_jax_bit_for_bit(shape, lena):
    img = np.ascontiguousarray(lena[: shape[0], : shape[1]])
    y = tcolor.rgb2ycbcr(img)
    assert_exact(y.numpy().view(np.int32), np.asarray(jcolor.rgb2ycbcr(img)).view(np.int32),
                 "rgb2ycbcr bits")
    assert_exact(tcolor.ycbcr2rgb(y).numpy().view(np.int32),
                 np.asarray(jcolor.ycbcr2rgb(y.numpy())).view(np.int32), "ycbcr2rgb bits")
    assert_exact(tcolor.rgb2gray(img).numpy().view(np.int32),
                 np.asarray(jcolor.rgb2gray(img)).view(np.int32), "rgb2gray bits")
    assert_exact(tcolor.rgb2ycbcr_ict(img).numpy().view(np.int32),
                 np.asarray(jcolor.rgb2ycbcr_ict(img)).view(np.int32), "ICT forward bits")
    ict = np.asarray(jcolor.rgb2ycbcr_ict(img))
    # XLA:CPU sums a dot's last pixels past a multiple of 16 in another
    # order: at 45x61 (2,745 pixels) the ICT inverse's last pixel rounds
    # channel 0, a plain sum, differently (1 of 8,235); 256x256 is exact
    assert_close(tcolor.ycbcr2rgb_ict(ict), jcolor.ycbcr2rgb_ict(ict), 1e-5, "ICT inverse")


def test_metrics_match_jax(lena, lena_rec):
    # float32 means of ~8e5 squares in another order: relative 1e-6
    mse = float(jmetrics.calc_mse(lena, lena_rec))
    assert_close(tmetrics.calc_mse(lena, lena_rec), mse, 1e-6 * mse, "mse")
    assert_close(tmetrics.calc_psnr(lena, lena_rec), jmetrics.calc_psnr(lena, lena_rec), 1e-4,
                 "psnr")
    gray = lena.mean(axis=-1)
    assert_close(tmetrics.calc_psnr(gray, torch.from_numpy(lena)),
                 jmetrics.calc_psnr(gray, lena), 1e-4, "gray vs rgb")
    with pytest.raises(ValueError):
        tmetrics.calc_mse(lena, lena[:8])
    for args in [(1000, (100, 50)), (1000, (4, 5, 3), True)]:
        assert tmetrics.calc_bpp(*args) == jmetrics.calc_bpp(*args)


def test_fixture_images_equal_jax():
    assert tfix._NAMED == jfix._NAMED
    for name in tfix._NAMED:
        assert np.array_equal(tfix.image(name), jfix.image(name)), name
    assert np.array_equal(tfix.degraded("lena"), jfix.degraded("lena"))
    with pytest.raises(KeyError):
        tfix.image("nope")
