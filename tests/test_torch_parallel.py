"""The port's (gop × tile)-sharded codec against the JAX package's.

JAX runs on the 8-device virtual CPU mesh of tests/conftest.py; the port
runs an in-process mesh on the CPU. Motion indices, words, offsets,
counts, group bits, totals, reconstructions and container bytes must be
equal exactly; decodes from the container stay within bench.py's 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from torch_parity import RECON_TOL, assert_close, assert_exact, luma, reference_state, to_torch

from ivclab_tpu.models.fastvideo import FusedVideoCodec as JaxCodec
from ivclab_tpu.models.videocodec import VideoCodec as JaxVideo
from ivclab_tpu.ops.motion_pallas import motion_search_tile_pallas
from ivclab_tpu.parallel import (
    assemble_video_payloads as j_assemble,
    build_sharded_video_codec as j_build_codec,
    build_sharded_video_encoder as j_build_encoder,
    make_mesh as j_make_mesh,
    shard_frames as j_shard_frames,
)
from ivclab_tpu.parallel.halo import (
    exchange_row_halo as j_exchange_row_halo,
    motion_compensate_tile_dense as j_motion_compensate_tile_dense,
    motion_search_tile as j_motion_search_tile,
)

import ivclab_tpu_torch.ops.motion as tmotion
import ivclab_tpu_torch.ops.transform as ttr
from ivclab_tpu_torch import FusedVideoCodec as TorchCodec
from ivclab_tpu_torch import VideoCodec as TorchVideo
from ivclab_tpu_torch import parallel as tpar
from ivclab_tpu_torch.parallel.mesh import _factor


def _frames(rng, H, W):
    ref = (rng.random((H, W)) * 255).astype(np.float32)
    cur = np.roll(ref, (3, -2), axis=(0, 1)).astype(np.float32)
    cur += rng.normal(0, 0.5, cur.shape).astype(np.float32)
    return ref, cur


def _band(ref, cur, i, band_h, sr):
    """Band i of the frame with its halo cut from the frame (zeros outside)."""
    H, W = ref.shape
    ext = np.zeros((band_h + 2 * sr, W), np.float32)
    lo, hi = i * band_h - sr, (i + 1) * band_h + sr
    ext[max(lo, 0) - lo:band_h + 2 * sr - (hi - min(hi, H))] = ref[max(lo, 0):min(hi, H)]
    return ext, cur[i * band_h:(i + 1) * band_h]


@pytest.mark.parametrize("sr", [2, 4])
@pytest.mark.parametrize("i", [0, 1, 3], ids=["top", "middle", "bottom"])
def test_band_search_matches_jax_and_pallas(i, sr):
    H, W, band_h = 64, 256, 16
    ref, cur = _frames(np.random.default_rng(10 * i + sr), H, W)
    ext, band = _band(ref, cur, i, band_h, sr)
    port = tmotion.motion_search_tile_reference(to_torch(ext), to_torch(band), i * band_h, H, sr)
    assert port.shape == (band_h // 8, W // 8)
    assert_exact(port, j_motion_search_tile(ext, band, i * band_h, H, sr), "vs JAX scan")
    assert_exact(port, motion_search_tile_pallas(ext, band, i * band_h, H, sr, interpret=True),
                 "vs Pallas")
    before = tmotion.TILE_LAUNCHES
    assert_exact(tmotion.motion_search_tile(to_torch(ext), to_torch(band), i * band_h, H, sr),
                 port, "CPU dispatch")
    assert tmotion.TILE_LAUNCHES == before


@pytest.mark.parametrize("sr", [2, 4])
def test_bands_concatenate_to_the_whole_frame_search(sr):
    H, W, band_h = 64, 256, 16
    ref, cur = _frames(np.random.default_rng(sr), H, W)
    bands = [tmotion.motion_search_tile_reference(*map(to_torch, _band(ref, cur, i, band_h, sr)),
                                                  i * band_h, H, sr) for i in range(4)]
    assert_exact(torch.cat(bands), tmotion.motion_search_reference(to_torch(ref), to_torch(cur), sr),
                 "bands vs whole frame")


@pytest.mark.parametrize("halo", [2, 4])
def test_exchange_row_halo_matches_jax(halo):
    mesh = j_make_mesh(n_gop=2, n_tile=4)
    x = np.random.default_rng(halo).random((64, 48)).astype(np.float32)
    fn = shard_map(lambda b: j_exchange_row_halo(b, halo, "tile"), mesh=mesh,
                   in_specs=P("tile"), out_specs=P("tile"), check_vma=False)
    want = np.asarray(jax.jit(fn)(x))
    tmesh = tpar.make_mesh(2, 4, device="cpu")
    got = tpar.exchange_row_halo(list(to_torch(x).chunk(4)), halo, tmesh)
    assert all(g.shape == (16 + 2 * halo, 48) for g in got)
    assert_exact(torch.cat(got).numpy().view(np.int32), want.view(np.int32), "halo bands")


def test_compensate_tile_matches_jax_dense_on_encoder_fields(foreman):
    y = luma(foreman[:2, :64, :352])
    sr, band_h = 4, 16
    for i in range(4):
        ext, band = _band(y[0], y[1], i, band_h, sr)
        mv = np.asarray(j_motion_search_tile(ext, band, i * band_h, 64, sr))
        port = tpar.motion_compensate_tile(to_torch(ext), to_torch(mv), sr)
        want = np.asarray(j_motion_compensate_tile_dense(ext, mv, sr))
        assert_exact(port.numpy().view(np.int32), want.view(np.int32), f"band {i} MC (bits)")


def test_sharded_codec_matches_jax_and_the_fused_pack(foreman):
    """test_parallel.py's sharded-codec case: foreman 256x352, mesh 2x4."""
    gop_len, n_tile = 2, 4
    y = luma(foreman[:4, :256, :352])
    T, H, W = y.shape
    band_h = H // n_tile
    j = JaxCodec(1.0).train(y[:2])
    for g in range(2):  # establishes the pack buckets, as the JAX test does
        j.pack_gop(j.encode_gop(jnp.asarray(y[g * 2:(g + 1) * 2]))[0])
    cap, bw, gw = j._buckets
    jmesh = j_make_mesh(n_gop=2, n_tile=n_tile)
    jout = j_build_codec(jmesh, j, gop_len, band_h, W, cap=cap, group_words=gw,
                         block_words=bw)(j_shard_frames(y, jmesh))

    t = TorchCodec.from_reference_state(reference_state(j), device="cpu")
    tmesh = tpar.make_mesh(2, n_tile, device="cpu")
    tout = tpar.build_sharded_video_codec(tmesh, t, gop_len, band_h, W, cap, gw, bw)(
        tpar.shard_frames(y, tmesh))
    for field in tout._fields:
        port, ref = getattr(tout, field), np.asarray(getattr(jout, field))
        if field == "recons":
            port, ref = port.numpy().view(np.int32), ref.view(np.int32)
        assert_exact(port, ref, field)

    blobs = tpar.assemble_video_payloads(t, tout, gop_len)
    assert blobs == j_assemble(j, jout, gop_len)
    for g, blob in enumerate(blobs):
        sl = slice(g * gop_len, (g + 1) * gop_len)
        qsyms, mvs, _, _ = t.encode_gop(y[sl])
        assert blob == t.container_from_packed(t.pack_gop(qsyms), mvs, (gop_len, H, W))
        recons, ok = TorchCodec.decode_from_container(blob, device="cpu")
        assert bool(ok)
        assert_close(recons, tout.recons[sl], RECON_TOL, f"GOP {g} container decode")


@pytest.mark.parametrize("policy", ["per-frame", "adaptive"])
def test_sharded_adaptive_encoder_matches_jax_single_device(foreman, policy):
    """test_parallel.py's adaptive case (foreman 256x352, mesh 2x4, 3-frame
    GOPs), held against the JAX package's single-device container bytes."""
    y = luma(foreman[:6, :256, :352])
    mesh = tpar.make_mesh(2, 4, device="cpu")
    enc = tpar.ShardedAdaptiveEncoder(mesh, 3, 64, 352, codebook_policy=policy)
    blobs = enc.encode(y)
    assert len(blobs) == 2 and enc.full_stride_frames == 0
    for g in range(2):
        want = JaxVideo(1.0, codebook_policy=policy).encode_to_container(y[3 * g:3 * g + 3])
        assert blobs[g] == want
        assert_close(TorchVideo.decode_from_container(blobs[g], device="cpu"),
                     JaxVideo.decode_from_container(want), RECON_TOL, f"GOP {g} decode")


def test_sharded_adaptive_pack_fallback_gives_the_same_bytes(foreman, monkeypatch):
    y = luma(foreman[:4, :256, :352])
    mesh = tpar.make_mesh(2, 4, device="cpu")
    want = tpar.ShardedAdaptiveEncoder(mesh, 2, 64, 352).encode(y)
    monkeypatch.setattr(ttr, "ADAPTIVE_WPG", 8)
    monkeypatch.setattr(ttr, "ADAPTIVE_BW", 2)
    enc = tpar.ShardedAdaptiveEncoder(mesh, 2, 64, 352)
    assert enc.encode(y) == want
    assert enc.full_stride_frames == 4  # every frame took the full-stride re-pack
    assert want[1] == TorchVideo(1.0, device="cpu").encode_to_container(y[2:])


def test_sharded_adaptive_encoder_refusals():
    mesh = tpar.make_mesh(1, 2, device="cpu")
    with pytest.raises(ValueError, match="policy"):
        tpar.ShardedAdaptiveEncoder(mesh, 2, 32, 64, codebook_policy="first-p-frame")
    with pytest.raises(ValueError, match="PACK_GROUP"):
        tpar.ShardedAdaptiveEncoder(mesh, 2, 24, 64)
    with pytest.raises(ValueError, match="multiples of 8"):
        tpar.ShardedAdaptiveEncoder(mesh, 2, 30, 64)
    with pytest.raises(ValueError):
        tpar.ShardedAdaptiveEncoder(mesh, 2, 32, 64).encode(np.zeros((3, 64, 64), np.float32))


class _Code:
    def __init__(self, lengths, lower_bound=0):
        self.lengths = np.asarray(lengths, np.int32)
        self.lower_bound = lower_bound


@pytest.mark.parametrize("codes", ["proxy", "given"])
def test_sharded_encoder_matches_jax(foreman, codes):
    """test_parallel.py's rate-only case: foreman 288x352, mesh 2x4."""
    y = luma(foreman[:4])
    kw = dict(quantization_scale=1.0)
    if codes == "given":
        rng = np.random.default_rng(3)
        kw.update(residual_code=_Code(rng.integers(2, 17, 4096), -2048),
                  mv_code=_Code(rng.integers(3, 9, 81)))
    jmesh = j_make_mesh(n_gop=2, n_tile=4)
    jrec, jbits = j_build_encoder(jmesh, 2, 72, 352, **kw)(j_shard_frames(y, jmesh))
    tmesh = tpar.make_mesh(2, 4, device="cpu")
    trec, tbits = tpar.build_sharded_video_encoder(tmesh, 2, 72, 352, **kw)(
        tpar.shard_frames(y, tmesh))
    assert_exact(tbits, np.asarray(jbits), "bits per frame")
    assert_exact(trec.numpy().view(np.int32), np.asarray(jrec).view(np.int32), "recons (bits)")
    assert tbits[1] < tbits[0] and tbits[3] < tbits[2]


@pytest.mark.parametrize("n,n_gop,n_tile,want", [
    (8, None, None, (2, 4)), (6, None, None, (3, 2)), (3, None, None, (3, 1)),
    (8, 4, None, (4, 2)), (8, None, 8, (1, 8)), (2, 1, 2, (1, 2)),
])
def test_mesh_factorisation_matches_jax(n, n_gop, n_tile, want):
    assert _factor(n, n_gop, n_tile) == want
    jm = j_make_mesh(n_gop, n_tile, devices=jax.devices()[:n])
    assert (jm.shape["gop"], jm.shape["tile"]) == want
    m = tpar.make_mesh(*want, device="cpu")
    assert m.shape == {"gop": want[0], "tile": want[1]} and not m.distributed
    assert m.local_shards() == [(g, i) for g in range(want[0]) for i in range(want[1])]
    assert m.device == torch.device("cpu")


def test_mesh_and_step_reject_what_they_cannot_run(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tpar.init_distributed() is False
    with pytest.raises(ValueError):
        tpar.make_mesh(2)  # in-process needs both sizes
    with pytest.raises(ValueError):
        _factor(8, 3, None)
    with pytest.raises(RuntimeError):
        tpar.make_mesh(distributed=True)
    mesh = tpar.make_mesh(1, 2, device="cpu")
    with pytest.raises(ValueError):
        tpar.shard_frames(np.zeros((2, 24, 64), np.float32), tpar.make_mesh(1, 5, device="cpu"))
    step = tpar.build_sharded_video_encoder(mesh, 2, 16, 64)
    shards = tpar.shard_frames(np.zeros((2, 32, 64), np.float32), mesh)
    with pytest.raises(ValueError):
        step({k: v for k, v in shards.items() if k != (0, 1)})
    with pytest.raises(ValueError):
        step({k: v[:1] for k, v in shards.items()})
    codec = TorchCodec(1.0, device="cpu").train(np.zeros((2, 24, 64), np.float32))
    with pytest.raises(ValueError):  # 3x8 = 24 blocks per band: not whole pack groups
        tpar.build_sharded_video_codec(mesh, codec, 2, 24, 64, 32, 64, 4)


@pytest.mark.parametrize("bad", ["cpu", "float64", "width", "sr"])
def test_band_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ext, band = torch.zeros((24, 32)), torch.zeros((16, 32))
    sr = 4
    if bad == "float64":
        ext, band = ext.double(), band.double()
    elif bad == "width":
        ext = torch.zeros((24, 40))
    elif bad == "sr":
        sr = 8
    with pytest.raises(ValueError):
        tmotion.motion_search_tile_cuda(ext, band, 0, 16, sr)
