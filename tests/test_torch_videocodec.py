"""Parity of the port's per-frame adaptive video codec with the JAX package's.

The same numpy frames go through ``ivclab_tpu.models.VideoCodec`` and
``ivclab_tpu_torch.VideoCodec`` (on the CPU). Container bytes, frame blobs
and bits must be equal exactly; luma reconstructions stay within
``RECON_TOL``. Both branches of the JAX ``_stream_histogram`` (its windowed
count and its full histogram), the out-of-window bounds fallback and the
speculative-bucket fallback are each forced here, and each test checks
that it took the route it names.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import RECON_TOL, assert_close, assert_exact, to_numpy, video_reference_state

import ivclab_tpu.models.videocodec as jvc
from ivclab_tpu.models import MotionCompensator as JaxCompensator
from ivclab_tpu.models import VideoCodec as JaxVideo
from ivclab_tpu.models.intracodec import bucket_bounds
from ivclab_tpu.ops.color import rgb2ycbcr as j_rgb2ycbcr
from ivclab_tpu.runtime.checkpoint import GopCheckpointer as JaxCheckpointer
from ivclab_tpu.utils import fixtures

import ivclab_tpu_torch.entropy.codebook as tcb
import ivclab_tpu_torch.models.videocodec as tvc
import ivclab_tpu_torch.ops.transform as ttr
from ivclab_tpu_torch import IntraCodec, MotionCompensator, VideoCodec, calc_psnr
from ivclab_tpu_torch.runtime import trace
from ivclab_tpu_torch.runtime.checkpoint import GopCheckpointer

POLICIES = ("per-frame", "adaptive", "first-p-frame")

# Pinned by tests/test_ch4_video.py from the deterministic foreman fixture.
GOLDEN_VIDEO_PSNR = 30.22
GOLDEN_VIDEO_BPP = 0.708


def _luma(rgb) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(j_rgb2ycbcr(rgb.astype(np.float32)))[..., 0])


@pytest.fixture(scope="module")
def rgb_video():
    return fixtures.video("container", num_frames=4, shape=(96, 128))


@pytest.fixture(scope="module")
def luma_video(rgb_video):
    return _luma(rgb_video)


@pytest.fixture(scope="module")
def jax_containers(luma_video):
    return {p: JaxVideo(1.0, codebook_policy=p).encode_to_container(luma_video)
            for p in POLICIES[:2]}


def _jax_histogram_route(frames, q: float, eob: int):
    """Per frame of the JAX container scan: (windowed branch taken, bounds
    inside the full-range window), read from JAX's own outputs: its ``mn``
    and ``mx``, and the largest non-EOB symbol of its buffers."""
    codec = JaxVideo(q, end_of_block=eob)
    qt, inv = codec.intra_codec._tables(1)
    T = frames.shape[0]
    outs = jvc._pframe_device_scan(jnp.asarray(frames), jnp.arange(T, dtype=jnp.int32),
                                   jnp.asarray(inv), jnp.asarray(qt), 4, eob)
    buf, valid, mn, mx = (np.asarray(o) for o in outs[:4])
    mask = np.arange(buf.shape[2])[None, None] < valid[..., None]
    mx_content = np.where(mask & (buf != eob), buf, jvc._WIN_LO).max(axis=(1, 2))
    windowed = (mn >= jvc._WIN_LO) & (mx_content < jvc._WIN_HI)
    inside = []
    for lo_hi in (bucket_bounds(int(a), int(b)) for a, b in zip(mn, mx)):
        inside.append(jvc._HIST_LO <= lo_hi[0] and lo_hi[1] <= jvc._HIST_HI)
    return windowed, np.asarray(inside), outs


# ------------------------------------------------------------ container


@pytest.mark.parametrize("policy", POLICIES[:2])
def test_encode_to_container_matches_jax(luma_video, jax_containers, policy):
    codec = VideoCodec(1.0, codebook_policy=policy, device="cpu")
    blob = codec.encode_to_container(luma_video)
    assert blob == jax_containers[policy]
    jrec = JaxVideo.decode_from_container(jax_containers[policy])
    rec = VideoCodec.decode_from_container(jax_containers[policy], device="cpu")
    assert isinstance(rec, np.ndarray) and rec.shape == luma_video.shape
    assert_close(rec, jrec, RECON_TOL, "decode vs JAX")
    assert_close(codec.decoder_recon, rec[-1], RECON_TOL, "decode vs the encoder's chain")
    dev, oks = VideoCodec.decode_from_container(blob, return_device=True, device="cpu")
    assert isinstance(dev, torch.Tensor) and bool(oks.all())
    assert np.array_equal(dev.numpy(), rec)


def test_encode_to_container_refusals(luma_video, jax_containers):
    with pytest.raises(ValueError, match="per-frame codebooks"):
        VideoCodec(codebook_policy="first-p-frame", device="cpu").encode_to_container(luma_video)
    with pytest.raises(ValueError, match="divisible by 8"):
        VideoCodec(device="cpu").encode_to_container(np.zeros((2, 20, 32), np.float32))
    bad = bytearray(jax_containers["per-frame"])
    bad[0] ^= 0xFF
    with pytest.raises(ValueError):
        VideoCodec.decode_from_container(bytes(bad), device="cpu")


def test_a_traced_encode_limits_its_codes_in_the_native_engine(monkeypatch):
    """Each frame whose Huffman lengths pass 26 bits is limited by the C++
    engine, counted inside its ``ivc.codebook.limit`` span; the bytes stay
    JAX's. At 256x480 three of the four frames' codes pass 26 bits."""
    frames = _luma(fixtures.video("container", num_frames=4, shape=(256, 480)))
    want = JaxVideo(1.0, codebook_policy="per-frame").encode_to_container(frames)
    depths, lengths_of = [], tcb.huffman_code_lengths

    def recorded(pmf):
        out = lengths_of(pmf)
        depths.append(int(out.max()))
        return out

    monkeypatch.setattr(tcb, "huffman_code_lengths", recorded)
    trace.enable()
    try:
        blob = VideoCodec(1.0, codebook_policy="per-frame", device="cpu").encode_to_container(
            frames)
        limits = [s for r in trace.requests() for s in r["spans"]
                  if s["name"] == "ivc.codebook.limit"]
        counts = trace.summary()["counts"]
    finally:
        trace.disable()
        trace.reset()
    assert blob == want
    over = sum(d > tcb.BUILD_MAX_LEN for d in depths)  # the motion code's 7 bits never pass
    assert len(limits) == len(depths) and over > 0
    assert counts["limit_native"] == over and counts["limit_moves"] > 0
    assert sum(s["counts"].get("limit_native", 0) for s in limits) == over
    assert sum(s["counts"].get("limit_moves", 0) for s in limits) == counts["limit_moves"]


def test_stream_histogram_matches_jax_on_both_branches():
    rng = np.random.default_rng(8)
    for lo, hi, windowed in ((-40, 60, True), (-700, 900, False)):
        buf = rng.integers(lo, hi, (64, 32)).astype(np.int32)
        buf[::3, 5] = 4000  # EOB symbols
        valid = rng.integers(0, 33, 64).astype(np.int32)
        jmn, jmx, jhist = jvc._stream_histogram(jnp.asarray(buf), jnp.asarray(valid), 4000)
        mn, mx, hist = tvc._stream_histogram(torch.from_numpy(buf), torch.from_numpy(valid))
        mask = np.arange(32)[None] < valid[:, None]
        content = np.where(mask & (buf != 4000), buf, jvc._WIN_LO).max()
        assert ((int(jmn) >= jvc._WIN_LO) and content < jvc._WIN_HI) == windowed
        assert (int(mn), int(mx)) == (int(jmn), int(jmx))
        assert_exact(hist, np.asarray(jhist), "histogram")


@pytest.mark.parametrize("route", ["windowed", "full", "outside"])
def test_histogram_routes_give_jax_bytes(luma_video, jax_containers, route):
    """Each route of the JAX codebook statistics: its windowed count (q=1.0),
    its full histogram (an I-frame at q=0.15, DC symbols past 576) and the
    direct histogram of bounds outside [_HIST_LO, _HIST_HI) (a bright frame
    at q=0.02 with EOB 8000)."""
    if route == "windowed":
        frames, q, eob = luma_video, 1.0, 4000
    elif route == "full":
        frames, q, eob = luma_video, 0.15, 4000
    else:
        frames, q, eob = np.clip(luma_video[:2] + 120, 0, 255).astype(np.float32), 0.02, 8000
    windowed, inside, jouts = _jax_histogram_route(frames, q, eob)
    if route == "windowed":
        assert windowed.all() and inside.all()
    elif route == "full":
        assert not windowed[0] and inside.all()
    else:
        assert not inside.any()
    want = (jax_containers["per-frame"] if route == "windowed"
            else JaxVideo(q, end_of_block=eob).encode_to_container(frames))
    codec = VideoCodec(q, end_of_block=eob, device="cpu")
    assert codec.encode_to_container(frames) == want
    # the port's statistics are JAX's integers whichever route JAX took
    qt, inv_qt = codec.intra_codec._tables(1)
    outs = tvc._pframe_scan(torch.from_numpy(frames), range(len(frames)), inv_qt, qt, 4, eob)
    for k, name in enumerate(("buffers", "counts", "min", "max")):
        assert_exact(outs[k], np.asarray(jouts[k]), name)
    for t in range(len(frames)):
        if inside[t]:
            assert_exact(outs[4][t], np.asarray(jouts[4][t]), f"frame {t} histogram")
    rec = VideoCodec.decode_from_container(want, device="cpu")
    assert_close(rec, JaxVideo.decode_from_container(want), RECON_TOL, "decode")


def test_sized_pack_fallback_gives_the_same_bytes(rgb_video, luma_video, jax_containers,
                                                  monkeypatch):
    """Buckets shrunk to 8 words a group and 2 a block overflow on every
    frame: the full-stride re-pack runs, and not a byte changes."""
    jax_facade = JaxVideo(1.0)
    jax_facade.encode_decode(rgb_video[0], frame_num=0)
    want_blob = jax_facade.encode_decode(rgb_video[1], frame_num=1)[1]

    full_packs = []
    real = tvc.pack_symbols_grouped
    monkeypatch.setattr(tvc, "pack_symbols_grouped",
                        lambda *a: full_packs.append(1) or real(*a))
    monkeypatch.setattr(ttr, "ADAPTIVE_WPG", 8)
    monkeypatch.setattr(ttr, "ADAPTIVE_BW", 2)
    assert VideoCodec(1.0, device="cpu").encode_to_container(luma_video) == \
        jax_containers["per-frame"]
    assert len(full_packs) == len(luma_video)
    codec = VideoCodec(1.0, device="cpu")
    codec.encode_decode(rgb_video[0], frame_num=0)
    assert codec.encode_decode(rgb_video[1], frame_num=1)[1] == want_blob
    assert len(full_packs) == len(luma_video) + 2


# ------------------------------------------------------------ facade


@pytest.fixture(scope="module")
def jax_facade(foreman):
    """JAX facade outputs on 3 foreman frames per policy, and each codec's
    state after frame 1."""
    out = {}
    for policy in POLICIES:
        codec = JaxVideo(1.0, codebook_policy=policy)
        frames, state = [], None
        for t in range(3):
            rgb, blob, bits = codec.encode_decode(foreman[t], frame_num=t)
            frames.append((np.asarray(rgb), blob, bits, np.asarray(codec.decoder_recon)))
            if t == 1:
                state = video_reference_state(codec)
        out[policy] = (frames, state)
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_facade_matches_jax(foreman, jax_facade, policy):
    codec = VideoCodec(1.0, codebook_policy=policy, device="cpu")
    prev = None
    for t, (jrgb, jblob, jbits, jrecon) in enumerate(jax_facade[policy][0]):
        rgb, blob, bits = codec.encode_decode(foreman[t], frame_num=t)
        assert bits == jbits, f"frame {t} bits"
        assert blob == jblob, f"frame {t} blob"
        assert_close(codec.decoder_recon, jrecon, RECON_TOL, f"frame {t} luma")
        # the facade's RGB is ycbcr2rgb of the decoded luma, which equals
        # JAX's within RECON_TOL, not bit for bit (the inverse DCT's float32
        # sums run in another order), so a value next to k + 1/2 may round
        # to the neighbouring level
        assert rgb.dtype == torch.uint8 and rgb.shape == jrgb.shape
        assert np.abs(rgb.numpy().astype(int) - jrgb.astype(int)).max() <= 1, f"frame {t} RGB"
        dec = VideoCodec.decode_frame_payload(blob, prev, device="cpu")
        assert_close(dec, codec.decoder_recon, RECON_TOL, f"frame {t} blob decode")
        assert_close(dec, JaxVideo.decode_frame_payload(jblob, None if prev is None else
                                                        to_numpy(prev)), RECON_TOL,
                     f"frame {t} vs JAX's blob decode")
        prev = dec


@pytest.mark.parametrize("policy", POLICIES)
def test_from_reference_state_continues_a_jax_sequence(foreman, jax_facade, policy):
    frames, state = jax_facade[policy]
    codec = VideoCodec.from_reference_state(state, device="cpu")
    rgb, blob, bits = codec.encode_decode(foreman[2], frame_num=2)
    _, jblob, jbits, jrecon = frames[2]
    assert (blob, bits) == (jblob, jbits)
    assert_close(codec.decoder_recon, jrecon, RECON_TOL, "frame 2 luma")
    again = VideoCodec.from_reference_state(tvc.reference_state(codec), device="cpu")
    assert again.codebook_policy == policy and torch.equal(again.decoder_recon,
                                                           codec.decoder_recon)


def test_decode_frame_payload_refusals(rgb_video):
    codec = VideoCodec(1.0, device="cpu")
    _, iblob, _ = codec.encode_decode(rgb_video[0], frame_num=0)
    _, pblob, _ = codec.encode_decode(rgb_video[1], frame_num=1)
    with pytest.raises(ValueError, match="previous reconstruction"):
        VideoCodec.decode_frame_payload(pblob, device="cpu")
    intra = IntraCodec(1.0, device="cpu")
    intra.train_huffman_from_image(rgb_video[0])
    for bad in (b"", b"IVC", intra.encode_to_container(rgb_video[0]), pblob[:40],
                iblob[:-9]):
        with pytest.raises(ValueError):
            VideoCodec.decode_frame_payload(bad, codec.decoder_recon, device="cpu")
    # an I-frame blob needs nothing but itself
    assert VideoCodec.decode_frame_payload(iblob, device="cpu").shape == rgb_video.shape[1:3]


def test_golden_point(foreman):
    codec = VideoCodec(1.0, device="cpu")
    psnrs, bits = [], []
    for t in range(4):
        rgb, _, b = codec.encode_decode(foreman[t], frame_num=t)
        psnrs.append(float(calc_psnr(foreman[t], rgb)))
        bits.append(b)
    assert abs(float(np.mean(psnrs)) - GOLDEN_VIDEO_PSNR) < 0.5
    assert abs(np.mean(bits) / (foreman[0].size / 3) - GOLDEN_VIDEO_BPP) < 0.25


def test_verify_entropy_gives_the_same_bits_and_recons(foreman):
    fast = VideoCodec(1.0, device="cpu").encode_decode_sequence(foreman[:3])
    slow = VideoCodec(1.0, verify_entropy=True, device="cpu").encode_decode_sequence(foreman[:3])
    assert np.array_equal(fast[1], slow[1])
    assert torch.equal(fast[0], slow[0])


# ------------------------------------------------------------ sequences


@pytest.mark.parametrize("policy", POLICIES[:2])
def test_pipelined_equals_serial(foreman, policy):
    frames = foreman[:4]
    s_rec, s_bits = VideoCodec(1.0, codebook_policy=policy, device="cpu").encode_decode_sequence(
        frames, gop_size=3)
    p_rec, p_bits = VideoCodec(1.0, codebook_policy=policy,
                               device="cpu").encode_decode_sequence_pipelined(frames, gop_size=3)
    assert np.array_equal(p_bits, s_bits)
    assert torch.equal(p_rec, s_rec)
    assert p_rec.shape == frames.shape and p_rec.dtype == torch.uint8


def test_pipelined_refuses_first_p_frame(foreman):
    with pytest.raises(ValueError, match="retrains per frame"):
        VideoCodec(1.0, codebook_policy="first-p-frame",
                   device="cpu").encode_decode_sequence_pipelined(foreman[:2])


def test_checkpointed_sequence_resumes(rgb_video, tmp_path, monkeypatch):
    want_rec, want_bits = VideoCodec(1.0, device="cpu").encode_decode_sequence(rgb_video,
                                                                               gop_size=2)
    ckpt = GopCheckpointer(tmp_path)
    rec, bits = VideoCodec(1.0, device="cpu").encode_decode_sequence_checkpointed(
        rgb_video, 2, ckpt)
    assert torch.equal(rec, want_rec) and np.array_equal(bits, want_bits)
    assert ckpt.completed_gops() == [0, 1] and ckpt.resume_plan(3) == [2]
    # the JAX package's checkpointer reads the port's files
    _, jrec, jbits = JaxCheckpointer(tmp_path).load_gop(1)
    assert np.array_equal(jrec, want_rec[2:].numpy()) and np.array_equal(jbits, want_bits[2:])

    (tmp_path / "gop_00001.npz").unlink()  # a run that died during GOP 1
    calls = []
    real = VideoCodec.encode_decode
    monkeypatch.setattr(VideoCodec, "encode_decode",
                        lambda self, f, frame_num=0: calls.append(frame_num) or real(self, f,
                                                                                     frame_num))
    rec, bits = VideoCodec(1.0, device="cpu").encode_decode_sequence_checkpointed(
        rgb_video, 2, GopCheckpointer(tmp_path))
    assert calls == [0, 1]  # only GOP 1 was encoded again
    assert torch.equal(rec, want_rec) and np.array_equal(bits, want_bits)


# ------------------------------------------------------------ motion facade


def test_motion_compensator_matches_jax():
    rng = np.random.default_rng(12)
    ref = (rng.random((32, 48)) * 255).astype(np.float32)
    cur = np.roll(ref, (1, -2), axis=(0, 1))
    port, jax_mc = MotionCompensator(4, device="cpu"), JaxCompensator(search_range=4)
    mv = port.compute_motion_vector(ref, cur)
    assert mv.shape == (4, 6, 1)
    assert_exact(mv, np.asarray(jax_mc.compute_motion_vector(ref, cur)), "motion field")
    for img in (ref, np.stack([ref, ref * 0.5], axis=-1)):
        got = port.reconstruct_with_motion_vector(img, mv)
        want = np.asarray(jax_mc.reconstruct_with_motion_vector(img, mv))
        assert got.shape == want.shape
        assert_exact(got.view(np.int32), want.astype(np.float32).view(np.int32), "prediction")
