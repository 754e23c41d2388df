"""The port's FusedVideoCodec against the JAX package's, end to end.

The port codec is built from the trained JAX codec's state
(``from_reference_state``) and both are driven through the same sequence
of GOPs, so the sticky pack buckets move together. Symbols, motion fields,
motion bits, packed words, offsets and container bytes must be equal;
reconstructions agree within the 1e-2 bound bench.py uses; each side
decodes the other's bytes.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import (
    RECON_TOL,
    assert_close,
    assert_exact,
    luma,
    reference_state,
    to_torch,
)

from ivclab_tpu.models.fastvideo import FusedVideoCodec as JaxCodec
from ivclab_tpu.utils import fixtures

from ivclab_tpu_torch import FusedVideoCodec as TorchCodec
from ivclab_tpu_torch.models import fastvideo as tfv
from ivclab_tpu_torch.utils import fixtures as tfixtures

REPO = Path(__file__).resolve().parents[1]


def _video(T, H, W):
    return luma(fixtures.video("bench", T, (H, W)))


def _assert_same_code(t, j):
    assert (t.lower_bound, t.alphabet_n, t.raw_bits, t.esc_rank) == (
        j.lower_bound, j.alphabet_n, j.raw_bits, j.esc_rank)
    assert_exact(t.hot_values, j.hot_values, "hot_values")
    assert_exact(t.code.lengths, j.code.lengths, "lengths")
    assert_exact(t.code.codes, j.code.codes, "codes")


def test_fixtures_are_identical():
    for args in [("bench", 3, (64, 128)), ("foreman", 2, (288, 352))]:
        np.testing.assert_array_equal(tfixtures.video(*args), fixtures.video(*args))


@pytest.mark.parametrize("H,W", [(64, 128), (128, 256)])
def test_train_matches(H, W):
    y = _video(2, H, W)
    j = JaxCodec(1.0).train(y)
    t = TorchCodec(1.0).train(y)
    _assert_same_code(t.residual_code, j.residual_code)
    _assert_same_code(t.mv_code, j.mv_code)


def _compare_gop(j, t, x):
    T, H, W = x.shape
    jq, jm, jb, jr = (np.asarray(a) for a in j.encode_gop(x))
    tq, tm, tb, tr = t.encode_gop(x)
    assert_exact(tq, jq, "qsyms")
    assert_exact(tm, jm, "mvs")
    assert_exact(tb, jb, "mv_bits")
    assert_close(tr, jr, RECON_TOL, "encoder recons")

    jp = j.pack_gop(jq)
    tp = t.pack_gop(to_torch(jq))
    for field in ("words", "totals", "offsets", "counts", "group_bits"):
        assert_exact(getattr(tp, field), getattr(jp, field), field)
    assert (tp.block_words, tp.cap, t._buckets) == (jp.block_words, jp.cap, j._buckets)
    assert bool(tp.ok) and bool(jp.ok)

    jrec, jok = j.decode_gop(jp.words, jp.offsets, jp.counts, jm, H, W, jp.block_words, jp.cap)
    trec, tok = t.decode_gop(tp.words, tp.offsets, tp.counts, to_torch(jm), H, W,
                             tp.block_words, tp.cap)
    assert bool(tok) and bool(jok)
    assert_close(trec, jrec, RECON_TOL, "decoded recons")
    assert_close(trec, tr, RECON_TOL, "decoder vs encoder")

    j_blob = j.container_from_packed(jp, jm, (T, H, W))
    t_blob = t.container_from_packed(tp, tm, (T, H, W))
    assert t_blob == j_blob
    assert t.encode_to_container(x) == j.encode_to_container(x)

    t_of_j, ok1 = TorchCodec.decode_from_container(j_blob)
    j_of_t, ok2 = JaxCodec.decode_from_container(t_blob)
    assert bool(ok1) and bool(ok2)
    assert_close(t_of_j, jrec, RECON_TOL, "port decodes JAX bytes")
    assert_close(j_of_t, trec, RECON_TOL, "JAX decodes port bytes")


@pytest.mark.parametrize("H,W,T,n_gops", [(64, 128, 3, 3), (128, 256, 2, 2)])
def test_gop_sequence_matches(H, W, T, n_gops):
    seq = _video(T * n_gops, H, W)
    j = JaxCodec(1.0).train(seq[:2])
    t = TorchCodec.from_reference_state(reference_state(j))
    for g in range(n_gops):
        _compare_gop(j, t, seq[g * T:(g + 1) * T])
        assert t._buckets == j._buckets


def test_encode_decode_gop_matches():
    seq = _video(4, 64, 128)
    j = JaxCodec(1.0, search_range=3).train(seq[:2])
    t = TorchCodec.from_reference_state(reference_state(j))
    jr, jbits, jok, jenc = j.encode_decode_gop(seq)
    tr, tbits, tok, tenc = t.encode_decode_gop(seq)
    assert bool(tok) and bool(jok)
    assert_exact(tbits, jbits, "bits per frame")
    assert_close(tr, jr, RECON_TOL, "recons")
    assert_close(tenc, jenc, RECON_TOL, "encoder recons")
    # default decode buckets (no block_words / cap given)
    jq, jm, _, _ = j.encode_gop(seq)
    jp = j.pack_gop(jq)
    tp = t.pack_gop(to_torch(jq))
    jrec, _ = j.decode_gop(jp.words, jp.offsets, jp.counts, jm, 64, 128)
    trec, _ = t.decode_gop(tp.words, tp.offsets, tp.counts, to_torch(jm), 64, 128)
    assert_close(trec, jrec, RECON_TOL, "default-bucket decode")


def test_sticky_bucket_violation_and_repack():
    seq = _video(3, 64, 128)
    j = JaxCodec(1.0).train(seq[:2])
    j._buckets = (32, 4, 64)  # too small for this content
    t = TorchCodec.from_reference_state(reference_state(j))
    assert t._buckets == (32, 4, 64)
    jq = np.asarray(j.encode_gop(seq)[0])
    jp = j.pack_gop(jq, check=False)
    tp = t.pack_gop(to_torch(jq), check=False)
    assert not bool(jp.ok) and not bool(tp.ok)
    assert isinstance(tp.ok, torch.Tensor)
    for field in ("words", "totals", "offsets", "counts", "group_bits"):
        assert_exact(getattr(tp, field), getattr(jp, field), f"overflowed {field}")
    jp = j.pack_gop(jq)  # check=True re-buckets and re-packs
    tp = t.pack_gop(to_torch(jq))
    assert bool(jp.ok) and bool(tp.ok)
    assert t._buckets == j._buckets != (32, 4, 64)
    assert_exact(tp.words, jp.words, "repacked words")
    tp2 = t.repack_gop(to_torch(jq))
    assert_exact(tp2.words, jp.words, "repack_gop")


def test_state_round_trip_keeps_the_codec():
    seq = _video(2, 64, 128)
    t = TorchCodec(1.0, search_range=2).train(seq)
    t2 = TorchCodec.from_reference_state(reference_state(t))
    assert t2.encode_to_container(seq) == t.encode_to_container(seq)
    with pytest.raises(ValueError):
        tfv._bucket(4096, tfv.GW_BUCKETS)
    assert (tfv.CAP_BUCKETS, tfv.GW_BUCKETS, tfv.BW_BUCKETS) == (
        (32, 64, 128), (64, 128, 256, 512, 1024, 2048), (4, 8, 16, 32, 64, 128))


def test_import_leaves_jax_out():
    code = (
        "import sys, ivclab_tpu_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ivclab_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert ivclab_tpu_torch.FusedVideoCodec and ivclab_tpu_torch.__version__\n"
        "print('CLEAN')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "CLEAN" in out.stdout, out.stderr


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from) (jax|jaxlib|ivclab_tpu)\b", re.M)
    sources = sorted((REPO / "ivclab_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    for path in sources:
        assert not pattern.search(path.read_text()), path
