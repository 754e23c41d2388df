"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card (sm_90a),
PyTorch built for CUDA and the CUDA toolkit:

    python3 chip_smoke.py

It imports neither JAX nor ``ivclab_tpu``. Phases, each fatal on failure:

1. device and build: requires CUDA, prints the card's name and power
   limit, builds ``ivclab_tpu_torch/csrc/motion_search.cu`` with nvcc and
   checks that TF32 is off;
2. kernel vs plain: the motion-search kernel against its plain PyTorch
   version on the card: exact on integer-valued and flat frames, and on
   float fixture frames every mismatch must be a verified near-tie; bit
   for bit against the kernel-order plain version (which repeats the
   kernel's summation) on the float fixture, on random float frames at
   288x352, 40x56 and 64x384 for sr 1..7 and for the wide kernel's sr 0,
   16 and 32, at 40x56, 64x384 and 1088x1920 for sr 8 and 15, at
   1088x1920 for sr 16, and on a 2-pixel-periodic pattern where many
   candidates tie, each case on the kernel its range belongs to
   (``me_kernel`` for 1..15, ``wide_kernel`` for the rest); search ranges
   -1 and 23170 are refused; times both at 1088x1920 (the kernel by its
   device time in a ``torch.profiler`` trace), the kernel at sr 8 and 15
   and the wide kernel at sr 0, 16 and 32 beside their bounds, and the
   plain version at sr 16;
3. cross-device integer exactness: one set of symbols and motion fields
   packed and serialized on CUDA and on the CPU gives identical bytes, and
   the two decodes agree;
4. the main path at full width: train, encode, pack and decode an 8-frame
   1920x1088 GOP through ``FusedVideoCodec`` on CUDA and through the IVC1
   container, with the decoder within 1e-2 of the encoder and PSNR-Y above
   28 dB; counts the kernel's launches over that run and times each stage;
5. band kernel vs plain: the kernel's band entry point (a row band with
   halo rows cut from the frame) against its plain PyTorch version at
   every band of 1088x1920 (4 bands) and 288x352 (2 bands) frames, sr 2, 4
   and 7: exact on integer-valued and flat frames, near-ties only on the
   float fixture, and the bands together equal to the whole-frame kernel;
   bit for bit against the kernel-order plain version at every band of
   phase 2's float and tie-heavy cases (sr 8, 15 and the wide kernel's 0,
   16 and 32 included); bad row windows are refused; times both on a
   272x1920 band, the kernel at sr 8 and 15 and the wide kernel at sr 0,
   16 and 32;
6. the sharded path at full width: ``build_sharded_video_codec`` on an
   in-process gop=2 x tile=4 mesh on the card over 16 1920x1088 frames
   (two 8-frame GOPs, 272-row bands), against ``FusedVideoCodec.pack_gop``
   of each GOP word for word; the assembled IVC1 bytes equal
   ``container_from_packed``'s and decode within 1e-2; counts the band
   kernel's launches over that run and times the sharded step against the
   fused encode+pack;
7. the intra codec at full width on CUDA (it runs no hand-written kernel;
   its stages are plain PyTorch and the C++ entropy engine, which must be
   built): (a) the ch3 point, trained on lena_small and coding lena at
   q=0.15, within the JAX golden bounds and at the CPU port's bpp; (b) lena
   tiled to 1088x1920 RGB at q=1.0, trained on itself: container bytes equal
   the CPU port's (or every differing symbol is a printed rounding tie), the
   CUDA decode within 1e-2 of ``encode_decode``, the CPU decode of the CUDA
   bytes within 1e-2 of the CUDA decode, and ``verify_entropy`` passing;
   (c) a 2048x1536 grayscale container round trip at q=2.0 above 25 dB;
   (d) the C++ engine packs (b)'s symbol stream into the device packer's
   words and decodes them back; (e) times each intra entry point on (b),
   and the host's pmf and Huffman tree inside its codebook training;
8. profile: one warm ``encode_gop`` of phase 4 and one warm sharded step
   of phase 6 under ``torch.profiler``: device ms, kernel launches, and the
   motion-search kernel's share;
9. the per-frame adaptive video codec at full width on CUDA: (a)
   ``VideoCodec.encode_to_container`` (per-frame policy) of phase 4's 8
   frames, decoded on the card within 1e-2 of the encoder's chain, PSNR-Y
   above 28 dB, exactly 7 whole-frame kernel launches; (b) the same for
   the adaptive policy, whose bits exceed (a)'s by exactly the codebook
   charge; (c) the CPU port's bytes on 3 frames equal the card's (or every
   differing symbol is a printed motion near-tie or rounding tie), and the
   card's bytes decode on the CPU within 1e-2; (d) three RGB frames of the
   facade ``encode_decode`` per policy, every blob decoded by
   ``decode_frame_payload`` within 1e-2, one launch per P-frame; (e) warm
   medians of the container encode, the device-resident decode and the
   pipelined sequence coder, the encode's stages, and one profile each of
   the encode and the decode; (f) a codec at search range 8: 3 frames
   whose bytes equal the CPU port's (or every differing symbol is a
   printed near-tie), one launch per P-frame;
10. the sharded adaptive encoder at full width: ``ShardedAdaptiveEncoder``
   on an in-process gop=2 x tile=4 mesh over phase 6's 16 frames, each
   GOP's bytes equal to the single-device ``encode_to_container``'s and
   decoded within 1e-2, exactly 56 band launches; warm medians against the
   single-device encode of the same frames;
11. the ch1/ch2 library at full width on CUDA, on lena tiled to 1088x1920
   RGB (it runs no hand-written kernel): (a) ``PredictiveCodec`` at q=1
   and q=4 with subsampled chroma, the decoder's wavefront rebuilding the
   encoder's reconstruction exactly, the total bits equal to the CPU
   port's and the RGB within 1 level of it; (b) ``three_pixels_predictor``
   with and without subsampling and ``min_entropy_predictor`` equal to the
   CPU port's; (c) ``yuv420compression`` (above 30 dB), ``ict_compression``
   in both chroma modes and ``FilterPipeline.filter_img`` within 1 level
   of the CPU port's (2 for the ICT's fft mode, which rounds between two
   FFTs); (d) warm medians of every entry point above, and
   profiles of ``PredictiveCodec.encode_decode``, one luma wavefront and
   the IIR decimate (device ms, launches, busy share);
12. the CLI on the card, in process through ``ivclab_tpu_torch.cli.main``,
   each run's stream byte for byte against the same run with ``--device
   cpu`` and its kernel launches counted: ``encode-video`` of 8 CIF
   foreman frames for the three codebook policies with ``--trace`` (stage
   times), at ``--search-range 16`` (the wide kernel), 3 frames at sr 0
   and 16 for both codecs, ``--mesh-gop 2 --mesh-tile 1`` over 16 frames
   in GOPs of 8 (the band entry point); ``decode-video`` to ``.npy``
   (within 1 level of the CPU's) and ``info`` of the sr=16 stream;
   ``rd-sweep --kind video --frames 3`` (every point equal to the CPU's);
   ``tools/dryrun.py::dryrun_multichip(8, "cuda")`` on a 2x4 mesh.

The line before the last is a JSON list of the kernels with their launch
counts over every main path above, times and bounds; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

SEED = 20261016


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def near_tie_gaps(ref, cur, a, b, sr: int, row0: int = 0):
    """For each block where the index fields a and b differ: (block, both
    SSDs, relative gap), the SSDs recomputed in float64 from the [H, W]
    frames; a and b cover frame rows row0 onward."""
    import numpy as np

    total = 2 * sr + 1
    ref64, cur64 = ref.astype(np.float64), cur.astype(np.float64)
    out = []
    for by, bx in np.argwhere(a != b):
        y0 = row0 + by * 8
        blk = cur64[y0:y0 + 8, bx * 8:bx * 8 + 8]
        ssd = []
        for idx in (a[by, bx], b[by, bx]):
            ry, rx = y0 + idx // total - sr, bx * 8 + idx % total - sr
            ssd.append(float(((blk - ref64[ry:ry + 8, rx:rx + 8]) ** 2).sum()))
        out.append(((row0 // 8 + by, bx), ssd, abs(ssd[0] - ssd[1]) / max(ssd[0], ssd[1], 1.0)))
    return out


def band_of(ref, cur, i: int, band_h: int, sr: int):
    """Band i of [H, W] frames on the card: the reference band with sr halo
    rows above and below cut from the frame (zeros outside it), and the
    current band."""
    import torch

    padded = torch.nn.functional.pad(ref, (0, 0, sr, sr))
    return (padded[i * band_h:(i + 1) * band_h + 2 * sr].contiguous(),
            cur[i * band_h:(i + 1) * band_h].contiguous())


WIDE_RANGES = (0, 16, 32)  # the wide kernel's search ranges in phases 2 and 5


def kernel_order_cases(fy):
    """(label, ref, cur, sr, band height) of the bit-for-bit checks against
    the kernel-order plain version: the float fixture pair, random float
    frames at three sizes for sr 1..7 and the wide kernel's sr 0, 16 and 32,
    at 40x56, 64x384 and 1088x1920 for sr 8 and 15 and at 1088x1920 for sr
    16, and a 2-pixel-periodic pattern on which every even displacement
    ties (sr 1..7 and 0, 16, 32)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    cases = [("float fixture 1088x1920 sr=4", fy[0], fy[1], 4, 272)]
    sizes = [((288, 352, 144), (*range(1, 8), *WIDE_RANGES)),
             ((40, 56, 8), (*range(1, 8), 8, 15, *WIDE_RANGES)),
             ((64, 384, 16), (*range(1, 8), 8, 15, *WIDE_RANGES)),
             ((1088, 1920, 272), (8, 15, 16))]
    for (H, W, band_h), srs in sizes:
        for sr in srs:
            ref = (rng.random((H, W)) * 255).astype(np.float32)
            cur = (np.roll(ref, (2, -3), (0, 1)) + rng.normal(0, 0.3, (H, W))).astype(np.float32)
            cases.append((f"random float {H}x{W} sr={sr}", ref, cur, sr, band_h))
    yy, xx = np.indices((288, 352))
    periodic = (40.0 * (2 * (yy % 2) + xx % 2) + 10.25).astype(np.float32)
    for sr in (*range(1, 8), *WIDE_RANGES):
        cases.append((f"2-periodic 288x352 sr={sr}", periodic, np.roll(periodic, (1, 0), (0, 1)),
                      sr, 144))
    return cases


def valid_candidate_share(H: int, W: int, sr: int, row0: int, total_h: int) -> float:
    """Share of the (2 sr + 1)^2 candidates of an [H, W] plane's blocks that
    lie inside the frame (rows row0.. of a total_h-row frame): what the wide
    kernel reads, where the bound counts every candidate."""
    import numpy as np

    d = np.arange(-sr, sr + 1)
    gy = row0 + np.arange(H // 8) * 8
    bx = np.arange(W // 8) * 8
    ny = ((gy[:, None] + d >= 0) & (gy[:, None] + d + 8 <= total_h)).sum(axis=1)
    nx = ((bx[:, None] + d >= 0) & (bx[:, None] + d + 8 <= W)).sum(axis=1)
    return float(ny.sum() * nx.sum()) / ((H // 8) * (W // 8) * (2 * sr + 1) ** 2)


def launch_counts():
    """(me_kernel frame, me_kernel band, wide_kernel frame, wide_kernel band)
    launches counted by the wrappers so far."""
    from ivclab_tpu_torch.ops import motion

    return (motion.LAUNCHES, motion.TILE_LAUNCHES, motion.WIDE_LAUNCHES,
            motion.WIDE_TILE_LAUNCHES)


def reset_launch_counts():
    from ivclab_tpu_torch.ops import motion

    motion.LAUNCHES = motion.TILE_LAUNCHES = 0
    motion.WIDE_LAUNCHES = motion.WIDE_TILE_LAUNCHES = 0


def profile_line(label: str, fn) -> None:
    """Phase 8: one call of ``fn`` under torch.profiler: device ms, kernel
    launches and the motion-search kernel's part."""
    from ivclab_tpu_torch.utils.timing import device_kernels

    kernels = device_kernels(fn)
    me = [us for name, us in kernels if "me_kernel" in name]
    total = sum(us for _, us in kernels)
    check(bool(me), f"{label}: the profile holds no motion-search kernel")
    print(f"[profile] {label}: {len(kernels)} kernel launches, {total / 1e3:.3f} device ms; "
          f"me_kernel {len(me)} launches, {sum(me) / 1e3:.4f} device ms "
          f"({sum(me) / len(me):.3f} us each, {sum(me) / total:.4f} of the device time)")


def luma(frames):
    import numpy as np

    return np.ascontiguousarray(frames.astype(np.float32).mean(axis=-1))


def codec_state(codec) -> dict:
    """The trained state ``FusedVideoCodec.from_reference_state`` takes."""
    def parts(code):
        return (code.lower_bound, code.alphabet_n, code.hot_values, code.code.lengths)

    return {
        "quantization_scale": codec.q,
        "search_range": codec.sr,
        "residual_code": parts(codec.residual_code),
        "mv_code": parts(codec.mv_code),
        "buckets": codec._buckets,
    }


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` synchronised wall times of ``fn`` after one warm-up."""
    import numpy as np
    import torch

    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


TIE_TOL = 1e-3  # a scaled coefficient this close to k + 1/2 may round either way


def rounding_ties(x_gpu, x_cpu, codec_gpu, codec_cpu):
    """Quantized symbols that differ between the two devices, each with its
    scaled coefficient on both and in float64, and its distance from k+1/2."""
    import numpy as np
    import torch

    from ivclab_tpu_torch.ops.dct import dct2_fused, dct2_kron_matrix
    from ivclab_tpu_torch.ops.transform import blocks_from_plane

    C = x_cpu.shape[2]
    _, _, q_gpu = codec_gpu._symbolize(x_gpu)
    _, _, q_cpu = codec_cpu._symbolize(x_cpu)
    diff = torch.nonzero(q_gpu.cpu() != q_cpu).tolist()
    if not diff:
        return []
    inv = codec_cpu._tables(C)[1].numpy()  # [C, 64] float32
    flat_cpu = blocks_from_plane(x_cpu)
    coeff_cpu = dct2_fused(flat_cpu)
    coeff_gpu = dct2_fused(blocks_from_plane(x_gpu)).cpu()
    K = dct2_kron_matrix(8, zigzag=True)
    out = []
    for n, k in diff:
        c = n % C
        s64 = float(K[k] @ flat_cpu[n].numpy().astype(np.float64)) * float(inv[c, k])
        s_cpu = float(np.float32(coeff_cpu[n, k].item()) * inv[c, k])
        s_gpu = float(np.float32(coeff_gpu[n, k].item()) * inv[c, k])
        dist = abs(s64 - (np.floor(s64) + 0.5))
        out.append((n, k, int(q_gpu[n, k]), int(q_cpu[n, k]), s_gpu, s_cpu, s64, dist))
    return out


INTRA_REPS = 5  # timed runs per intra stage, after one warm-up


def intra_phase(dev, card: str) -> None:
    """Phase 7: the intra codec at full width on CUDA (see the module doc)."""
    import numpy as np
    import torch

    from ivclab_tpu_torch import HuffmanCoder, IntraCodec, calc_psnr
    from ivclab_tpu_torch.entropy.codebook import (
        BUILD_MAX_LEN,
        huffman_code_lengths,
        limit_code_lengths,
    )
    from ivclab_tpu_torch.entropy.stats import pmf_from_histogram
    from ivclab_tpu_torch.models.intracodec import reference_state
    from ivclab_tpu_torch.ops.transform import symbol_histogram
    from ivclab_tpu_torch.runtime import native
    from ivclab_tpu_torch.utils import fixtures

    t0 = time.perf_counter()
    lib = native.get_lib()
    check(lib is not None, f"C++ entropy engine unavailable: {native.unavailable_reason()}")
    print(f"[intra] C++ entropy engine {lib._name} from ivclab_tpu_torch/csrc/entropy.cpp, "
          f"loaded in {time.perf_counter() - t0:.2f} s")
    lena_small, lena = fixtures.image("lena_small"), fixtures.image("lena")

    # (a) the canonical ch3 point
    ga = IntraCodec(0.15, device=dev)
    ga.train_huffman_from_image(lena_small)
    rec_a, _, _, bpp_a = ga.encode_decode(lena, return_bpp=True)
    check(rec_a.is_cuda and tuple(rec_a.shape) == lena.shape, "ch3 recon not on the card")
    psnr_a = float(calc_psnr(lena, rec_a))
    ca = IntraCodec(0.15, device="cpu")
    ca.train_huffman_from_image(lena_small)
    _, _, _, bpp_cpu = ca.encode_decode(lena, return_bpp=True)
    print(f"[intra] (a) train lena_small, code lena 512x512 q=0.15: PSNR {psnr_a:.4f} dB, "
          f"{bpp_a!r} bpp (CPU port {bpp_cpu!r} bpp; JAX golden 38.93 +/- 0.3 dB, "
          f"4.518 +/- 0.15 bpp)")
    check(abs(psnr_a - 38.93) < 0.3, f"ch3 PSNR {psnr_a} outside 38.93 +/- 0.3")
    check(abs(bpp_a - 4.518) < 0.15, f"ch3 bpp {bpp_a} outside 4.518 +/- 0.15")
    check(bpp_a == bpp_cpu, f"ch3 bpp on CUDA {bpp_a} != CPU {bpp_cpu}")

    # (b) 1088x1920 RGB at q=1.0, trained on itself
    H, W = 1088, 1920
    hd = np.ascontiguousarray(np.tile(lena, (3, 4, 1))[:H, :W])
    g = IntraCodec(1.0, device=dev)
    g.train_huffman_from_image(hd)
    c = IntraCodec.from_reference_state(reference_state(g), device="cpu")
    blob = g.encode_to_container(hd)
    blob_cpu = c.encode_to_container(hd)
    print(f"[intra] (b) {W}x{H} RGB q=1.0: CUDA {len(blob)} container bytes, CPU "
          f"{len(blob_cpu)}, identical {blob == blob_cpu}")
    if blob != blob_cpu:
        ties = rounding_ties(g._prepare(hd, True)[0], c._prepare(hd, True)[0], g, c)
        for n, k, qg, qc, s_gpu, s_cpu, s64, dist in ties:
            print(f"[intra] symbol differs: block {n} coefficient {k}: CUDA {qg} (scaled "
                  f"{s_gpu!r}), CPU {qc} (scaled {s_cpu!r}), float64 {s64!r}, "
                  f"{dist:.3e} from k+1/2")
        check(ties and all(t[-1] < TIE_TOL for t in ties),
              "CUDA and CPU intra bytes differ by more than rounding ties")
    ref, _, bits_b, bpp_b = g.encode_decode(hd, return_bpp=True)
    rec = IntraCodec.decode_from_container(blob, device=dev)
    rec_cpu = IntraCodec.decode_from_container(blob, device="cpu")
    full, _, _ = g.encode_decode(hd, verify_entropy=True)
    check(rec.is_cuda and tuple(rec.shape) == hd.shape and bool(torch.isfinite(rec).all()),
          "bad 1080p intra recon")
    err = float((rec - ref).abs().max())
    err_cpu = float((rec_cpu - rec.cpu()).abs().max())
    err_v = float((full - ref).abs().max())
    psnr_b = float(calc_psnr(hd, rec))
    print(f"[intra] (b) decode on CUDA vs encode_decode max abs {err:.3e}, CPU decode of the CUDA "
          f"bytes vs CUDA decode {err_cpu:.3e}, verify_entropy vs direct {err_v:.3e}; "
          f"PSNR {psnr_b:.4f} dB, {bpp_b!r} bpp, {bits_b} payload bits, {len(blob)} bytes")
    check(err < 1e-2, f"1080p container decode mismatch {err}")
    check(err_cpu < 1e-2, f"CPU decode of CUDA bytes mismatch {err_cpu}")
    check(err_v < 1e-2, f"verify_entropy mismatch {err_v}")

    # (c) 2048x1536 grayscale at q=2.0
    gray = np.ascontiguousarray(np.tile(lena.mean(axis=-1).astype(np.uint8), (4, 3))[:2048, :1536])
    g2 = IntraCodec(2.0, device=dev)
    g2.train_huffman_from_image(gray, is_source_rgb=False)
    blob2 = g2.encode_to_container(gray, is_source_rgb=False)
    rec2 = IntraCodec.decode_from_container(blob2, device=dev)
    psnr_c = float(calc_psnr(gray, rec2))
    print(f"[intra] (c) 1536x2048 gray q=2.0: {len(blob2)} bytes, container round trip "
          f"PSNR {psnr_c:.4f} dB")
    check(rec2.is_cuda and psnr_c > 25.0, f"2048x1536 gray PSNR {psnr_c}")

    # (d) the C++ engine on (b)'s symbol stream
    stream = g.image2symbols(hd)
    x, _ = g._prepare(hd, True)
    dwords, dtotal, _, _, _ = g._encode_device(x)
    dtotal = int(dtotal)
    dev_words = dwords[: (dtotal + 31) // 32].cpu().numpy().astype(np.uint32)
    pack_t, dec_t = [], []
    for _ in range(INTRA_REPS):
        t0 = time.perf_counter()
        words, bits = g.huffman.encode(stream)
        t1 = time.perf_counter()
        back = g.huffman.decode(words, stream.size)
        pack_t.append((t1 - t0) * 1e3)
        dec_t.append((time.perf_counter() - t1) * 1e3)
    print(f"[intra] (d) C++ engine on {stream.size} symbols: words equal the device pack "
          f"{np.array_equal(words, dev_words)} ({bits:.0f} bits vs {dtotal}), decode returns the "
          f"stream {np.array_equal(back, stream)}; pack {np.median(pack_t):.3f} ms, decode "
          f"{np.median(dec_t):.3f} ms (median of {INTRA_REPS}, host; {card})")
    check(np.array_equal(words, dev_words) and int(bits) == dtotal,
          "C++ pack != device pack_symbols stream")
    check(np.array_equal(back, stream), "C++ decode did not return the symbol stream")

    # (e) timing of (b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stages = {
        "train_huffman_from_image": lambda: g.train_huffman_from_image(hd),
        "encode_to_container": lambda: g.encode_to_container(hd),
        "decode_from_container": lambda: IntraCodec.decode_from_container(blob, device=dev),
        "encode_decode": lambda: g.encode_decode(hd),
    }
    med = {name: median_ms(fn, INTRA_REPS) for name, fn in stages.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    mpix = H * W / 1e6
    for name, ms in med.items():
        print(f"[intra] (e) {W}x{H} RGB q=1.0 {name}: {ms:.3f} ms (warm, synchronised, "
              f"median of {INTRA_REPS}) = {mpix / ms * 1e3:.3f} Mpix/s ({card})")
    print(f"[intra] (e) peak device memory over the timed runs: {peak:.1f} MiB "
          f"(max_memory_allocated; {card})")

    # the host share of train_huffman_from_image: the pmf and the tree
    buf, valid_len, _ = g._symbolize(x)
    lo, hi = g.bounds
    hist = symbol_histogram(buf, valid_len, lo, hi).cpu().numpy()
    pmf = pmf_from_histogram(hist).astype(np.float64)
    raw = huffman_code_lengths(pmf)
    tree = HuffmanCoder(lower_bound=lo).train(pmf)
    check(np.array_equal(tree.code.lengths, g.huffman.code.lengths),
          "host tree != the codec's trained codebook")
    host = {
        "pmf_from_histogram": lambda: pmf_from_histogram(hist),
        "HuffmanCoder.train": lambda: HuffmanCoder(lower_bound=lo).train(pmf),
        "limit_code_lengths": lambda: limit_code_lengths(raw, BUILD_MAX_LEN),
    }
    host_ms = {name: median_ms(fn, INTRA_REPS) for name, fn in host.items()}
    print(f"[intra] (e) host share of train_huffman_from_image, {hist.size}-symbol alphabet, "
          f"longest unlimited code {int(raw.max())} bits: "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in host_ms.items())
          + f" (median of {INTRA_REPS}, host; {card})")


def encoder_chain(codec, y_dev):
    """The per-frame outputs of the recursion ``encode_to_container`` runs
    (buffers, counts, bounds, histograms, motion fields, reconstructions),
    for the checks; its kernel launches are not the main path's."""
    from ivclab_tpu_torch.models.videocodec import _pframe_scan

    qt, inv_qt = codec.intra_codec._tables(1)
    return _pframe_scan(y_dev, range(y_dev.shape[0]), inv_qt, qt, codec.search_range,
                        codec.end_of_block)


def psnr_y(rec, y) -> float:
    """Mean over frames of each frame's PSNR against the luma ``y``."""
    import numpy as np

    mse = ((rec.astype(np.float64) - y) ** 2).mean(axis=(1, 2))
    return float(np.mean(20 * np.log10(255.0 / np.sqrt(np.maximum(mse, 1e-12)))))


def adaptive_divergence(y3, codec_g, codec_c) -> bool:
    """Phase 9(c) when the card's and the CPU's bytes differ: at the first
    frame whose symbols differ, print each differing motion index as a
    near-tie (both SSDs in float64) and each coefficient that rounds
    differently under the same motion field as a rounding tie; later frames
    descend from different references and are not compared. Returns True
    when every difference is a tie."""
    import numpy as np
    import torch

    from ivclab_tpu_torch.ops.motion import motion_compensate

    outs = {}
    for name, codec in (("cuda", codec_g), ("cpu", codec_c)):
        outs[name] = [x.cpu() for x in encoder_chain(codec, torch.from_numpy(y3).to(codec.device))]
    bufs_g, valid_g, *_, mvs_g, rec_g, _ = outs["cuda"]
    bufs_c, valid_c, *_, mvs_c, rec_c, _ = outs["cpu"]
    for t in range(y3.shape[0]):
        if torch.equal(mvs_g[t], mvs_c[t]) and torch.equal(valid_g[t], valid_c[t]) \
                and torch.equal(bufs_g[t], bufs_c[t]):
            continue
        ok = True
        a, b = mvs_g[t].numpy(), mvs_c[t].numpy()
        if t and (a != b).any():
            ties = near_tie_gaps(rec_c[t - 1].numpy(), y3[t], a, b, codec_c.search_range)
            for blk, ssd, gap in ties:
                print(f"[adaptive] (c) frame {t} motion differs at block {blk}: CUDA ssd "
                      f"{ssd[0]!r}, CPU ssd {ssd[1]!r}, relative gap {gap:.3e}")
            ok = all(gap < 1e-5 for *_, gap in ties)
        planes = []
        for codec, rec in ((codec_g, rec_g), (codec_c, rec_c)):
            yt = torch.from_numpy(y3[t]).to(codec.device)
            if t:  # both under the CPU's motion field: only rounding can differ
                yt = yt - motion_compensate(rec[t - 1].to(codec.device), mvs_c[t],
                                            codec_c.search_range)
            planes.append(yt[:, :, None].contiguous())
        ties = rounding_ties(planes[0], planes[1], codec_g.intra_codec, codec_c.intra_codec)
        for n, k, qg, qc, s_gpu, s_cpu, s64, dist in ties:
            print(f"[adaptive] (c) frame {t} block {n} coefficient {k}: CUDA {qg} (scaled "
                  f"{s_gpu!r}), CPU {qc} (scaled {s_cpu!r}), float64 {s64!r}, {dist:.3e} "
                  f"from k+1/2")
        print(f"[adaptive] (c) frame {t} is the first that differs; frames after it are not "
              f"compared")
        return ok and all(tie[-1] < TIE_TOL for tie in ties)
    return True


ADAPTIVE_REPS = 5  # timed runs per adaptive entry point, after one warm-up


def adaptive_phase(dev, card: str, y, rgb) -> int:
    """Phase 9: ``VideoCodec`` at full width on CUDA (see the module doc).
    Returns the whole-frame kernel launches of its main-path runs."""
    import numpy as np
    import torch

    from ivclab_tpu_torch import VideoCodec, calc_psnr
    from ivclab_tpu_torch.models import videocodec as vc
    from ivclab_tpu_torch.ops import motion
    from ivclab_tpu_torch.ops.transform import cap_slice
    from ivclab_tpu_torch.ops.zerorun import BLOCK_CAP
    from ivclab_tpu_torch.runtime.container import AdaptiveVideoPayload
    from ivclab_tpu_torch.utils.timing import device_kernels

    T, H, W = y.shape
    y_dev = torch.from_numpy(y).to(dev)
    launches = 0

    # (a) and (b): each policy's container, decoded on the card
    blobs = {}
    for policy in ("per-frame", "adaptive"):
        codec = VideoCodec(1.0, codebook_policy=policy, device=dev)
        torch.cuda.synchronize()
        motion.LAUNCHES = 0
        blob = codec.encode_to_container(y_dev)
        torch.cuda.synchronize()
        n = motion.LAUNCHES
        launches += n
        rec, oks = VideoCodec.decode_from_container(blob, return_device=True, device=dev)
        chain = encoder_chain(codec, y_dev)[6]
        err = float((rec - chain).abs().max())
        last = float((chain[-1] - codec.decoder_recon).abs().max())
        ps = psnr_y(rec.cpu().numpy(), y)
        p = AdaptiveVideoPayload.from_bytes(blob)
        jax_ref = (" (the JAX package's per-frame container of the same frames: 2,050,144 "
                   "bytes, 31.17 dB; BENCH_r05.json adaptive_1080p, motion searched on a TPU)"
                   if policy == "per-frame" else "")
        print(f"[adaptive] ({'a' if policy == 'per-frame' else 'b'}) {policy} {W}x{H} T={T} "
              f"q=1.0 sr=4: {len(blob)} container bytes{jax_ref}, {p.payload_bits} "
              f"payload bits, frame bits {[int(b) for b in p.frame_bits]}; decode on the card vs "
              f"the encoder's chain max abs {err:.3e}, ok {bool(oks.all())}; PSNR-Y {ps:.4f} dB; "
              f"whole-frame kernel launches {n} in encode_to_container")
        check(bool(oks.all()) and err < 1e-2 and last < 1e-2,
              f"{policy}: adaptive container decode mismatch {err}")
        check(ps > 28.0, f"{policy}: PSNR-Y collapsed: {ps}")
        check(n == T - 1, f"{policy}: {n} whole-frame launches in encode_to_container, not {T - 1}")
        blobs[policy] = blob
    pf = AdaptiveVideoPayload.from_bytes(blobs["per-frame"])
    pa = AdaptiveVideoPayload.from_bytes(blobs["adaptive"])
    charged = [int(a) - int(f) for a, f in zip(pa.frame_bits, pf.frame_bits)]
    want = [0] + [8 * ((8 + cb.lengths.size) + 12) for cb, _ in pa.frames[1:]]
    print(f"[adaptive] (b) adaptive - per-frame bits per frame {charged} = the serialized "
          f"codebooks' charge {want}")
    check(charged == want, "adaptive policy's codebook charge")

    # (c) the CPU port on the first 3 frames
    y3 = np.ascontiguousarray(y[:3])
    cg = VideoCodec(1.0, device=dev)
    cc = VideoCodec(1.0, device="cpu")
    blob_g = cg.encode_to_container(torch.from_numpy(y3).to(dev))
    blob_c = cc.encode_to_container(y3)
    print(f"[adaptive] (c) 3 frames: CUDA {len(blob_g)} bytes, CPU {len(blob_c)} bytes, "
          f"identical {blob_g == blob_c}")
    if blob_g != blob_c:
        check(adaptive_divergence(y3, cg, cc), "CUDA and CPU adaptive bytes differ by more than "
                                               "motion near-ties and rounding ties")
    rec_g = VideoCodec.decode_from_container(blob_g, return_device=True, device=dev)[0]
    rec_c = VideoCodec.decode_from_container(blob_g, device="cpu")
    gap = float(np.abs(rec_c - rec_g.cpu().numpy()).max())
    print(f"[adaptive] (c) the CPU decode of the CUDA bytes vs the CUDA decode: max abs {gap:.3e}")
    check(gap < 1e-2, f"CPU decode of the CUDA adaptive bytes mismatch {gap}")

    # (d) the facade, three RGB frames per policy
    for policy in ("per-frame", "adaptive", "first-p-frame"):
        codec = VideoCodec(1.0, codebook_policy=policy, device=dev)
        prev, per_frame, info = None, [], []
        for t in range(3):
            torch.cuda.synchronize()
            motion.LAUNCHES = 0
            out, blob, bits = codec.encode_decode(rgb[t], frame_num=t)
            torch.cuda.synchronize()
            per_frame.append(motion.LAUNCHES)
            dec = VideoCodec.decode_frame_payload(blob, prev, device=dev)
            err = float((dec - codec.decoder_recon).abs().max())
            check(err < 1e-2, f"facade {policy} frame {t}: blob decode mismatch {err}")
            check(out.device.type == dev.type and out.dtype == torch.uint8
                  and tuple(out.shape) == rgb[t].shape,
                  f"facade {policy}: bad RGB output")
            info.append(f"{len(blob)} B / {bits} bits / {float(calc_psnr(rgb[t], out)):.3f} dB "
                        f"/ decode max abs {err:.1e}")
            prev = dec
        launches += sum(per_frame)
        print(f"[adaptive] (d) facade {policy} {W}x{H} RGB, 3 frames: {'; '.join(info)}; "
              f"whole-frame launches per frame {per_frame}")
        check(per_frame == [0, 1, 1], f"facade {policy}: launches {per_frame}, not [0, 1, 1]")

    # (e) timing and one profile
    codec = VideoCodec(1.0, device=dev)
    blob = codec.encode_to_container(y_dev)
    rgb_dev = torch.from_numpy(np.ascontiguousarray(rgb[:T])).to(dev)
    stages = {
        "encode_to_container": lambda: codec.encode_to_container(y_dev),
        "decode_from_container(return_device=True)":
            lambda: VideoCodec.decode_from_container(blob, return_device=True, device=dev),
        "encode_decode_sequence_pipelined": lambda: codec.encode_decode_sequence_pipelined(rgb_dev),
    }
    med = {name: median_ms(fn, ADAPTIVE_REPS) for name, fn in stages.items()}
    for name, ms in med.items():
        print(f"[adaptive] (e) {W}x{H} T={T} per-frame {name}: {ms:.3f} ms per GOP (warm, "
              f"synchronised, median of {ADAPTIVE_REPS}) = {T * H * W / ms / 1e3:.3f} Mpix/s "
              f"({card})")
    # encode_to_container's stages, each synchronised on its own
    qt, inv_qt = codec.intra_codec._tables(1)
    outs = vc._pframe_scan(y_dev, range(T), inv_qt, qt, 4, codec.end_of_block)
    codes, vmax_np, mvs_np = codec._per_frame_codes(outs)
    frames = [(outs[0][t], outs[1][t], cap_slice(int(vmax_np[t]), BLOCK_CAP), codes[t])
              for t in range(T)]
    packed = vc._pack_frames(frames)
    parts = {
        "device loop": lambda: vc._pframe_scan(y_dev, range(T), inv_qt, qt, 4, codec.end_of_block),
        "statistics fetch and host codebooks": lambda: codec._per_frame_codes(outs),
        "packs with their sidecar and word fetches": lambda: vc._pack_frames(frames),
        "motion pack and serialisation": lambda: vc._adaptive_payload(
            1.0, codec.end_of_block, 4, "per-frame", (T, H, W), codes, packed, mvs_np,
            codec.motion_huffman.code),
    }
    part_ms = {name: median_ms(fn, ADAPTIVE_REPS) for name, fn in parts.items()}
    print(f"[adaptive] (e) encode_to_container by stage, ms per GOP (median of {ADAPTIVE_REPS}): "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in part_ms.items()) + f" ({card})")

    for label, fn, wall in (
            ("encode_to_container", lambda: codec.encode_to_container(y_dev),
             med["encode_to_container"]),
            ("decode_from_container(return_device=True)",
             stages["decode_from_container(return_device=True)"],
             med["decode_from_container(return_device=True)"])):
        kernels = device_kernels(fn)
        total = sum(us for _, us in kernels)
        by_name: dict = {}
        for name, us in kernels:
            n, s = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, s + us)
        lead = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
        print(f"[profile] adaptive {label} {W}x{H} T={T}: {len(kernels)} kernel launches, "
              f"{total / 1e3:.3f} device ms, busy share {total / 1e3 / wall:.3f} of the median "
              f"wall time; leading: "
              + "; ".join(f"{name[:60]} {s / 1e3:.3f} ms x{n}" for name, (n, s) in lead)
              + f" ({card})")

    # (f) a codec at search range 8 on 3 frames against the CPU port
    c8 = VideoCodec(1.0, search_range=8, device=dev)
    y3_dev = torch.from_numpy(y3).to(dev)
    torch.cuda.synchronize()
    motion.LAUNCHES = 0
    blob8 = c8.encode_to_container(y3_dev)
    torch.cuda.synchronize()
    n8 = motion.LAUNCHES
    launches += n8
    c8_cpu = VideoCodec(1.0, search_range=8, device="cpu")
    blob8_cpu = c8_cpu.encode_to_container(y3)
    rec8 = VideoCodec.decode_from_container(blob8, return_device=True, device=dev)[0]
    err8 = float((rec8 - encoder_chain(c8, y3_dev)[6]).abs().max())
    print(f"[adaptive] (f) search range 8, 3 frames: CUDA {len(blob8)} bytes, CPU "
          f"{len(blob8_cpu)} bytes, identical {blob8 == blob8_cpu}; whole-frame launches {n8}; "
          f"decode vs the encoder's chain max abs {err8:.3e}; PSNR-Y "
          f"{psnr_y(rec8.cpu().numpy(), y3):.4f} dB")
    check(n8 == 2, f"search range 8: {n8} whole-frame launches, not 2")
    check(err8 < 1e-2, f"search range 8: decode mismatch {err8}")
    if blob8 != blob8_cpu:
        check(adaptive_divergence(y3, c8, c8_cpu), "CUDA and CPU bytes at search range 8 differ "
                                                   "by more than near-ties")
    return launches


def sharded_adaptive_phase(dev, card: str, y6) -> int:
    """Phase 10: ``ShardedAdaptiveEncoder`` on an in-process gop=2 x tile=4
    mesh on the card. Returns the band kernel's launches in its main-path
    run."""
    import numpy as np
    import torch

    from ivclab_tpu_torch import VideoCodec
    from ivclab_tpu_torch import parallel
    from ivclab_tpu_torch.ops import motion

    T6, H, W = y6.shape
    n_gop, n_tile = 2, 4
    gop_len, band_h = T6 // n_gop, H // n_tile
    y6_dev = torch.from_numpy(y6).to(dev)
    mesh = parallel.make_mesh(n_gop, n_tile, device=dev)
    enc = parallel.ShardedAdaptiveEncoder(mesh, gop_len, band_h, W)
    torch.cuda.synchronize()
    motion.LAUNCHES = motion.TILE_LAUNCHES = 0
    blobs = enc.encode(y6_dev)
    torch.cuda.synchronize()
    tile_launches, whole = motion.TILE_LAUNCHES, motion.LAUNCHES
    print(f"[shard-adaptive] {W}x{H} T={T6} mesh gop={n_gop} x tile={n_tile} (bands of {band_h} "
          f"rows) per-frame q=1.0 sr=4: band-kernel launches {tile_launches}, whole-frame "
          f"launches {whole}, full-stride re-packs {enc.full_stride_frames}")
    check(tile_launches == n_gop * (gop_len - 1) * n_tile and whole == 0,
          f"sharded adaptive launches: {tile_launches} band, {whole} whole-frame")

    single = VideoCodec(1.0, device=dev)
    for g in range(n_gop):
        gop = y6_dev[g * gop_len:(g + 1) * gop_len]
        want = single.encode_to_container(gop)
        rec, oks = VideoCodec.decode_from_container(blobs[g], return_device=True, device=dev)
        err = float((rec - encoder_chain(single, gop)[6]).abs().max())
        print(f"[shard-adaptive] GOP {g}: {len(blobs[g])} bytes, identical to the single-device "
              f"encode_to_container {blobs[g] == want}; decode vs the encoder's chain max abs "
              f"{err:.3e}, ok {bool(oks.all())}")
        check(blobs[g] == want, f"GOP {g}: sharded adaptive bytes != single-device bytes")
        check(bool(oks.all()) and err < 1e-2, f"GOP {g}: sharded adaptive decode mismatch {err}")

    def single_pair():
        for g in range(n_gop):
            single.encode_to_container(y6_dev[g * gop_len:(g + 1) * gop_len])

    times = {"sharded": [], "single": []}
    for i in range(ADAPTIVE_REPS + 1):  # alternate; the first round is warm-up
        for name, fn in (("sharded", lambda: enc.encode(y6_dev)), ("single", single_pair)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                times[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[shard-adaptive] warm ms per GOP pair (median of {ADAPTIVE_REPS}, synchronised): "
          f"sharded encode {med['sharded']:.3f}, single-device encode_to_container x2 "
          f"{med['single']:.3f} ({card})")
    print(f"[shard-adaptive] ms samples: {json.dumps(times)}")
    return tile_launches


LIBRARY_REPS = 5  # timed runs per ch1/ch2 entry point, after one warm-up


def uint8_gap(a, b) -> tuple[int, int]:
    """(largest level difference, count of differing values) of two uint8 images."""
    d = (a.cpu().int() - b.cpu().int()).abs()
    return int(d.max()), int((d > 0).sum())


def profile_summary(fn, wall_ms: float) -> str:
    """Device ms, kernel launches and busy share (device ms / wall ms) of one
    call of ``fn`` under torch.profiler."""
    from ivclab_tpu_torch.utils.timing import device_kernels

    kernels = device_kernels(fn)
    total = sum(us for _, us in kernels) / 1e3
    return (f"{len(kernels)} kernel launches, {total:.3f} device ms, busy share "
            f"{total / wall_ms:.3f} of the median wall time")


def library_phase(dev, card: str, H: int = 1088, W: int = 1920) -> None:
    """Phase 11: the ch1/ch2 library at full width on CUDA (see the module
    doc); it runs no hand-written kernel."""
    import numpy as np
    import torch

    from ivclab_tpu_torch import (
        FilterPipeline,
        PredictiveCodec,
        calc_psnr,
        ict_compression,
        min_entropy_predictor,
        three_pixels_predictor,
        yuv420compression,
    )
    from ivclab_tpu_torch.models.predictive import COEFFS_CBCR, COEFFS_Y
    from ivclab_tpu_torch.ops.predictive import predict_from_neighbors, reconstruct_from_residual
    from ivclab_tpu_torch.ops.resample import _decimate_iir
    from ivclab_tpu_torch.utils import fixtures

    img = np.ascontiguousarray(np.tile(fixtures.image("lena"), (3, 4, 1))[:H, :W])
    img_dev = torch.from_numpy(img).to(dev)
    wall = {}

    # (a) PredictiveCodec, subsampled chroma, q = 1 and 4
    for q in (1.0, 4.0):
        codec = PredictiveCodec(q, subsample_chroma=True, device=dev)
        rec, bits, bpp = codec.encode_decode(img_dev, return_bpp=True)
        (res_y, rec_y, y), (res_c, rec_c, cbcr) = codec._residuals(img_dev)
        inv_y = reconstruct_from_residual(res_y, y[0], y[:, 0], COEFFS_Y, q)
        inv_c = reconstruct_from_residual(res_c, cbcr[0], cbcr[:, 0], COEFFS_CBCR, q)
        gap_dec = max(float((inv_y - rec_y).abs().max()), float((inv_c - rec_c).abs().max()))
        rec_cpu, bits_cpu = PredictiveCodec(q, subsample_chroma=True,
                                            device="cpu").encode_decode(img)
        worst, n = uint8_gap(rec, rec_cpu)
        print(f"[library] (a) PredictiveCodec {W}x{H} q={q:g} subsampled chroma: {bits} bits "
              f"({bpp:.6f} bpp), CPU port {bits_cpu} bits; PSNR {float(calc_psnr(img, rec)):.4f} "
              f"dB; decoder wavefront vs encoder reconstruction max abs {gap_dec:.1e}; RGB vs the "
              f"CPU port: {n} values differ, by at most {worst}")
        check(rec.device.type == dev.type and rec.dtype == torch.uint8 and tuple(rec.shape) == img.shape,
              "PredictiveCodec: bad RGB output")
        check(gap_dec == 0.0, f"PredictiveCodec q={q}: the decoder's wavefront differs {gap_dec}")
        check(bits == bits_cpu, f"PredictiveCodec q={q}: {bits} bits on CUDA, {bits_cpu} on CPU")
        check(worst <= 1 and n <= 2e-4 * rec.numel(),
              f"PredictiveCodec q={q}: {n} RGB values differ by up to {worst} levels from the CPU's")
        wall[f"PredictiveCodec.encode_decode q={q:g}"] = (
            lambda c=codec: c.encode_decode(img_dev))

    # (b) the predictors against the CPU port
    for sub in (False, True):
        got = three_pixels_predictor(img_dev, sub, device=dev)
        want = three_pixels_predictor(img, sub, device="cpu")
        same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        print(f"[library] (b) three_pixels_predictor subsample={sub}: residuals {tuple(got[0].shape)}"
              f" and {tuple(got[1].shape)} equal the CPU port's {same}")
        check(same, f"three_pixels_predictor subsample={sub}: CUDA != CPU")
        wall[f"three_pixels_predictor subsample={sub}"] = (
            lambda sub=sub: three_pixels_predictor(img_dev, sub, device=dev))
    gray = np.ascontiguousarray(img.mean(axis=-1).astype(np.uint8))
    got = min_entropy_predictor(gray, device=dev)
    want = min_entropy_predictor(gray, device="cpu")
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    print(f"[library] (b) min_entropy_predictor: residuals and prediction equal the CPU port's "
          f"{same}")
    check(same, "min_entropy_predictor: CUDA != CPU")
    gray_dev = torch.from_numpy(gray).to(dev)
    wall["min_entropy_predictor"] = lambda: min_entropy_predictor(gray_dev, device=dev)

    # (c) the chroma-subsampling codecs and the filter pipeline. cuFFT and
    # pocketfft round the FFT otherwise, so a value next to k + 1/2 before
    # a rounding may land either way: 1 level in the RGB, 2 for the ICT's
    # fft mode, which rounds the FFT-downsampled chroma and then upsamples
    # it (one chroma level is up to 1.772 RGB levels)
    pipe, pipe_cpu = FilterPipeline(device=dev), FilterPipeline(device="cpu")
    for name, fn, cpu_fn, levels in (
            ("yuv420compression", lambda x: yuv420compression(x, device=dev),
             lambda x: yuv420compression(x, device="cpu"), 1),
            ("ict_compression fft", lambda x: ict_compression(x, "fft", device=dev),
             lambda x: ict_compression(x, "fft", device="cpu"), 2),
            ("ict_compression fir", lambda x: ict_compression(x, "fir", device=dev),
             lambda x: ict_compression(x, "fir", device="cpu"), 1),
            ("FilterPipeline.filter_img", pipe.filter_img, pipe_cpu.filter_img, 1)):
        out = fn(img_dev)
        worst, n = uint8_gap(out, cpu_fn(img))
        psnr = float(calc_psnr(img, out))
        print(f"[library] (c) {name} {W}x{H}: PSNR {psnr:.4f} dB; vs the CPU port {n} of "
              f"{out.numel()} values differ, by at most {worst} (limit {levels})")
        check(out.device.type == dev.type and out.dtype == torch.uint8
              and tuple(out.shape) == img.shape, f"{name}: bad output")
        check(worst <= levels and n <= 2e-4 * out.numel(),
              f"{name}: {n} values differ by up to {worst} levels from the CPU port")
        if name == "yuv420compression":
            check(psnr > 30.0, f"yuv420compression PSNR {psnr}")
        wall[name] = lambda fn=fn: fn(img_dev)

    # (d) warm medians and profiles
    med = {name: median_ms(fn, LIBRARY_REPS) for name, fn in wall.items()}
    for name, ms in med.items():
        print(f"[library] (d) {W}x{H} {name}: {ms:.3f} ms (warm, synchronised, median of "
              f"{LIBRARY_REPS}) ({card})")
    y_dev = img_dev.float().mean(-1, keepdim=True).contiguous()
    cbcr_dev = y_dev.expand(H, W, 2).contiguous()
    wave_ms = median_ms(lambda: predict_from_neighbors(y_dev, COEFFS_Y), LIBRARY_REPS)
    iir_ms = median_ms(lambda: _decimate_iir(_decimate_iir(cbcr_dev, 0), 1), LIBRARY_REPS)
    for label, fn, ms in (
            ("PredictiveCodec.encode_decode q=1",
             wall["PredictiveCodec.encode_decode q=1"], med["PredictiveCodec.encode_decode q=1"]),
            (f"one luma wavefront {W}x{H} q=1 ({H + W - 3} diagonals), {wave_ms:.3f} ms",
             lambda: predict_from_neighbors(y_dev, COEFFS_Y), wave_ms),
            (f"the IIR decimate of two {W}x{H} planes by 2 per axis (filtfilt: 2 x "
             f"{H + 54} + 2 x {W + 54} steps), {iir_ms:.3f} ms",
             lambda: _decimate_iir(_decimate_iir(cbcr_dev, 0), 1), iir_ms)):
        print(f"[profile] library {label}: {profile_summary(fn, ms)} ({card})")

def run_cli(*argv) -> dict:
    """``ivclab_tpu_torch.cli.main(argv)`` in this process; its JSON report
    (the last line it prints), echoed with a prefix."""
    import contextlib
    import io

    from ivclab_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(list(argv))
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def cli_phase(card: str) -> tuple[int, int, int]:
    """Phase 12: the CLI on the card, in process, each run against the same
    run with ``--device cpu``. Returns the (me_kernel frame, me_kernel band,
    wide_kernel) launches of its main-path runs."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from ivclab_tpu_torch.tools.dryrun import dryrun_multichip

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    totals = [0, 0, 0]

    def on_card(label, argv, want):
        """One CLI run on the card (launches counted) and its CPU twin."""
        torch.cuda.synchronize()
        reset_launch_counts()
        out = run_cli("--device", "cuda", *argv(tmp / f"{label}.cuda"))
        torch.cuda.synchronize()
        counts = launch_counts()
        totals[0] += counts[0]
        totals[1] += counts[1]
        totals[2] += counts[2] + counts[3]
        ref = run_cli("--device", "cpu", *argv(tmp / f"{label}.cpu"))
        same = (tmp / f"{label}.cuda").read_bytes() == (tmp / f"{label}.cpu").read_bytes()
        print(f"[cli] {label}: {out.get('container_bytes')} bytes, stream == --device cpu "
              f"{same}; launches me_kernel {counts[0]} frame / {counts[1]} band, wide_kernel "
              f"{counts[2]} frame / {counts[3]} band (want {want}); PSNR-Y "
              f"{out.get('mean_psnr_y_db')} dB (cpu {ref.get('mean_psnr_y_db')}), mean bpp "
              f"{out.get('mean_bpp')} (cpu {ref.get('mean_bpp')})")
        if "trace" in out:
            print(f"[cli] {label} stages ({card}): " + ", ".join(
                f"{name} {row['total_s'] * 1e3:.3f} ms / {row['calls']} calls"
                for name, row in out["trace"].items()))
        check(same, f"CLI {label}: the card's stream differs from --device cpu")
        check(counts == want, f"CLI {label}: launches {counts}, not {want}")
        for key in ("container_bytes", "frames", "gops", "mean_bpp", "per_frame_bits"):
            check(out[key] == ref[key], f"CLI {label}: {key} {out[key]} != cpu {ref[key]}")
        check(abs(out["mean_psnr_y_db"] - ref["mean_psnr_y_db"]) <= 1e-3,
              f"CLI {label}: PSNR-Y off the CPU's")
        return out

    T = 8
    enc = ["encode-video", "fixture:foreman"]
    for policy in ("first-p-frame", "per-frame", "adaptive"):
        # first-p-frame searches once in training and once a P-frame
        want = (T if policy == "first-p-frame" else T - 1, 0, 0, 0)
        on_card(f"{policy} CIF T={T}", lambda p, policy=policy: [
            "--trace", *enc, str(p), "--frames", str(T), "--codebook-policy", policy], want)
    on_card(f"first-p-frame CIF T={T} sr=16", lambda p: [
        "--trace", *enc, str(p), "--frames", str(T), "--search-range", "16"], (0, 0, T, 0))
    for policy, sr in (("first-p-frame", 0), ("per-frame", 0), ("per-frame", 16)):
        on_card(f"{policy} CIF T=3 sr={sr}", lambda p, policy=policy, sr=sr: [
            *enc, str(p), "--frames", "3", "--search-range", str(sr), "--codebook-policy",
            policy], (0, 0, 3 if policy == "first-p-frame" else 2, 0))
    mesh_T = 16
    on_card(f"first-p-frame CIF T={mesh_T} --gop 8 mesh 2x1", lambda p: [
        "--trace", *enc, str(p), "--frames", str(mesh_T), "--gop", "8",
        "--mesh-gop", "2", "--mesh-tile", "1"], (8, 14, 0, 0))

    # decode-video and info on the card's sr=16 stream, against the CPU
    stream = tmp / f"first-p-frame CIF T={T} sr=16.cuda"
    dec = {d: run_cli("--device", d, "--trace", "decode-video", str(stream),
                      str(tmp / f"dec-{d}.npy")) for d in ("cuda", "cpu")}
    a, b = np.load(tmp / "dec-cuda.npy"), np.load(tmp / "dec-cpu.npy")
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    print(f"[cli] decode-video sr=16 stream to .npy: {dec['cuda']['frames']} frames "
          f"{dec['cuda']['shape']}, card vs cpu: {int((diff > 0).sum())} of {diff.size} pixels "
          f"differ, by at most {int(diff.max())} (limit 1 level, 1e-4 of the pixels); "
          f"decode {dec['cuda']['trace']['decode']['total_s'] * 1e3:.3f} ms ({card})")
    check(a.shape == (T, 288, 352) and diff.max() <= 1 and (diff > 0).sum() <= 1e-4 * diff.size,
          "decode-video: the card's frames differ from the CPU's")
    info = {d: run_cli("--device", d, "info", str(stream)) for d in ("cuda", "cpu")}
    print(f"[cli] info: {info['cuda']['kind']}, {len(info['cuda']['gops'])} GOP(s), search range "
          f"{info['cuda']['gops'][0]['search_range']}; equal on both devices "
          f"{info['cuda'] == info['cpu']}")
    check(info["cuda"] == info["cpu"] and info["cuda"]["gops"][0]["search_range"] == 16,
          "info differs between the devices")

    # rd-sweep --kind video: the facade, one whole-frame launch a P-frame
    torch.cuda.synchronize()
    reset_launch_counts()
    sweep = run_cli("--device", "cuda", "rd-sweep", "--kind", "video", "--frames", "3")
    torch.cuda.synchronize()
    counts = launch_counts()
    totals[0] += counts[0]
    sweep_cpu = run_cli("--device", "cpu", "rd-sweep", "--kind", "video", "--frames", "3")
    n_q = len(sweep["points"])
    print(f"[cli] rd-sweep video 3 frames: {n_q} points, launches {counts} (want "
          f"{(2 * n_q, 0, 0, 0)}); " + "; ".join(
              f"q={p['q']} {p['bpp']} bpp {p['psnr_db']} dB" for p in sweep["points"]))
    check(counts == (2 * n_q, 0, 0, 0), f"rd-sweep launches {counts}")
    for p, q in zip(sweep["points"], sweep_cpu["points"]):
        same = p["q"] == q["q"] and p["bpp"] == q["bpp"]
        check(same and abs(p["psnr_db"] - q["psnr_db"]) <= 1e-3,
              f"rd-sweep point q={p['q']}: card {p}, cpu {q}")

    # the multi-shard dry run, in process on the card: 2x4 mesh
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    dryrun_multichip(8, "cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    totals[0] += counts[0]
    totals[1] += counts[1]
    print(f"[cli] dryrun_multichip(8, 'cuda'): passed in {time.perf_counter() - t0:.2f} s, "
          f"launches {counts}")
    check(counts[1] > 0, "dryrun_multichip launched no band search")
    return tuple(totals)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")

    from ivclab_tpu_torch import FusedVideoCodec
    from ivclab_tpu_torch.ops import motion
    from ivclab_tpu_torch.ops.dct import require_full_fp32
    from ivclab_tpu_torch.runtime import cuda_build
    from ivclab_tpu_torch.utils import fixtures
    from ivclab_tpu_torch.utils.timing import cuda_ms, kernel_device_us, motion_search_bound

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    lib_path, log = cuda_build.build("motion_search")
    build_s = time.perf_counter() - t0
    print(f"[build] {lib_path.name} from ivclab_tpu_torch/csrc/motion_search.cu "
          f"in {build_s:.2f} s")
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"[build] {line.strip()}")
    spills = [line for line in log.splitlines()
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", line))]
    check(not spills, f"ptxas reports spills: {spills}")
    require_full_fp32()
    check(torch.backends.cuda.matmul.allow_tf32 is False, "cuda matmul TF32 is on")
    check(torch.backends.cudnn.allow_tf32 is False, "cudnn TF32 is on")
    print("[build] TF32 off for cuda matmul and cudnn")

    # ------------------------------------------------ 2. kernel vs plain
    rng = np.random.default_rng(SEED)
    max_abs_err = 0
    for H, W, sr in [(1088, 1920, 4), (288, 352, 4), (40, 56, 4), (64, 384, 2)]:
        ref = rng.integers(0, 256, (H, W)).astype(np.float32)
        cases = {
            "moved": np.roll(ref, (3, -2), (0, 1)) + rng.integers(-3, 4, (H, W)),
            "random": rng.integers(0, 256, (H, W)),
        }
        for name, cur in cases.items():
            R = torch.from_numpy(ref).to(dev)
            C = torch.from_numpy(cur.astype(np.float32)).to(dev)
            a = motion.motion_search_cuda(R, C, sr)
            b = motion.motion_search_reference(R, C, sr)
            torch.cuda.synchronize()
            bad = int((a != b).sum())
            max_abs_err = max(max_abs_err, int((a - b).abs().max()))
            print(f"[me] {H}x{W} sr={sr} integer {name}: {bad} of {a.numel()} differ")
            check(bad == 0, f"kernel != plain on integer frames {H}x{W} sr={sr} ({name})")
        for lv_ref, lv_cur in [(128.0, 128.0), (100.0, 120.0)]:
            R = torch.full((H, W), lv_ref, device=dev)
            C = torch.full((H, W), lv_cur, device=dev)
            a = motion.motion_search_cuda(R, C, sr)
            b = motion.motion_search_reference(R, C, sr)
            torch.cuda.synchronize()
            bad = int((a != b).sum())
            max_abs_err = max(max_abs_err, int((a - b).abs().max()))
            print(f"[me] {H}x{W} sr={sr} flat {lv_ref:g}/{lv_cur:g}: {bad} differ")
            check(bad == 0, f"kernel != plain on flat frames {H}x{W} sr={sr}")

    T, H, W = 8, 1088, 1920
    rgb = fixtures.video("bench", T, (H, W))
    y = luma(rgb)
    fy = y[:2]
    R, C = torch.from_numpy(fy[0]).to(dev), torch.from_numpy(fy[1]).to(dev)
    a = motion.motion_search_cuda(R, C, 4).cpu().numpy()
    b = motion.motion_search_reference(R, C, 4).cpu().numpy()
    ties = near_tie_gaps(fy[0], fy[1], a, b, 4)
    worst_gap = max((gap for *_, gap in ties), default=0.0)
    for (by, bx), ssd, gap in ties:
        print(f"[me] near-tie block ({by}, {bx}): kernel {a[by, bx]} ssd {ssd[0]!r}, "
              f"plain {b[by, bx]} ssd {ssd[1]!r}, relative gap {gap:.3e}")
    print(f"[me] float fixture 1088x1920: {len(ties)} of {a.size} differ, "
          f"largest relative SSD gap {worst_gap:.3e}")
    check(worst_gap < 1e-5, "a float mismatch is not a near-tie")

    order_cases = kernel_order_cases(fy)
    wide_err = 0
    for label, r_np, c_np, sr, _ in order_cases:
        R2, C2 = torch.from_numpy(r_np).to(dev), torch.from_numpy(c_np).to(dev)
        before = launch_counts()
        a = motion.motion_search_cuda(R2, C2, sr)
        wide = launch_counts()[2] > before[2]
        check(wide == (sr == 0 or sr >= 16), f"{label}: launched the wrong kernel")
        b = motion.motion_search_kernel_order(R2, C2, sr)
        bad = int((a != b).sum())
        err = int((a - b).abs().max())
        if wide:
            wide_err = max(wide_err, err)
        else:
            max_abs_err = max(max_abs_err, err)
        print(f"[me] kernel-order plain, {label} ({'wide_kernel' if wide else 'me_kernel'}): "
              f"{bad} of {a.numel()} differ")
        check(bad == 0, f"kernel != kernel-order plain: {label}")

    for _ in range(3):
        motion.motion_search_cuda(R, C, 4)
        motion.motion_search_reference(R, C, 4)
    kernel_us, event_ms, plain_ms = [], [], []
    for _ in range(2):  # alternate, kernel first then plain
        kernel_us.append(float(np.mean(kernel_device_us(
            lambda: motion.motion_search_cuda(R, C, 4), 50, "me_kernel"))))
        event_ms.append(cuda_ms(lambda: motion.motion_search_cuda(R, C, 4), 50))
        plain_ms.append(cuda_ms(lambda: motion.motion_search_reference(R, C, 4), 10))
    me_ms, me_plain_ms = float(np.mean(kernel_us)) / 1e3, float(np.mean(plain_ms))
    me_bound = motion_search_bound(H, H, W, 4)
    print(f"[me] 1088x1920 sr=4 kernel {kernel_us} us device (mean of 50 launches), {event_ms} ms "
          f"per call (CUDA events, host enqueue included), plain {plain_ms} ms; bound "
          f"{me_bound[0] * 1e3:.3f} us ({me_bound[1]}), {me_bound[0] / me_ms:.3f} of it ({card})")
    for sr in (8, 15):
        motion.motion_search_cuda(R, C, sr)
        us = float(np.mean(kernel_device_us(lambda: motion.motion_search_cuda(R, C, sr), 20,
                                            "me_kernel")))
        bound = motion_search_bound(H, H, W, sr)
        print(f"[me] 1088x1920 sr={sr} kernel {us:.3f} us device (mean of 20 launches); bound "
              f"{bound[0] * 1e3:.3f} us ({bound[1]}), {bound[0] * 1e3 / us:.3f} of it ({card})")
    # the wide kernel (sr 0, 16, 32) on the frame; the plain version only at
    # sr 16, where it takes 1,089 candidate passes over the frame
    wide_frame = {}
    for sr in WIDE_RANGES:
        motion.motion_search_cuda(R, C, sr)
        us = float(np.mean(kernel_device_us(lambda: motion.motion_search_cuda(R, C, sr), 10,
                                            "wide_kernel")))
        bound = motion_search_bound(H, H, W, sr)
        wide_frame[sr] = (us / 1e3, bound)
        print(f"[me] 1088x1920 sr={sr} wide_kernel {us:.3f} us device (mean of 10 launches); "
              f"bound {bound[0] * 1e3:.3f} us ({bound[1]}; every candidate, "
              f"{valid_candidate_share(H, W, sr, 0, H):.4f} of them in the frame), "
              f"{bound[0] * 1e3 / us:.4f} of it ({card})")
    wide_ms, wide_bound = wide_frame[16]
    wide_plain_ms = cuda_ms(lambda: motion.motion_search_reference(R, C, 16), 2)
    print(f"[me] 1088x1920 sr=16 plain {wide_plain_ms:.3f} ms per call (CUDA events, mean of 2) "
          f"({card})")
    before = launch_counts()
    for sr in (-1, 23170):
        try:
            motion.motion_search_cuda(R, C, sr)
        except ValueError as e:
            print(f"[me] sr={sr} refused: {e}")
        else:
            fail(f"the kernels took search_range {sr}")
    check(launch_counts() == before, "a refused search range counted a launch")

    # ------------------------------------- 3. cross-device integer exactness
    small = luma(fixtures.video("bench", 4, (256, 480)))
    cg = FusedVideoCodec(1.0, 4, device=dev).train(small[:2])
    qsyms, mvs, _, _ = cg.encode_gop(small)
    cc = FusedVideoCodec.from_reference_state(codec_state(cg), device="cpu")
    pg, pc = cg.pack_gop(qsyms), cc.pack_gop(qsyms.cpu())
    bg = cg.container_from_packed(pg, mvs, small.shape)
    bc = cc.container_from_packed(pc, mvs.cpu(), small.shape)
    print(f"[pack] 256x480 T=4: CUDA {len(bg)} bytes, CPU {len(bc)} bytes, "
          f"identical {bg == bc}")
    check(bg == bc, "CUDA and CPU container bytes differ")
    rg, okg = FusedVideoCodec.decode_from_container(bg, device=dev)
    rc, okc = FusedVideoCodec.decode_from_container(bc, device="cpu")
    gap = float((rg.cpu() - rc).abs().max())
    print(f"[pack] decode CUDA vs CPU max abs {gap:.3e}, ok {bool(okg)} {bool(okc)}")
    check(bool(okg) and bool(okc) and gap < 1e-2, "CUDA and CPU decodes disagree")

    # --------------------------------------- 4. the main path at full width
    y_dev = torch.from_numpy(y).to(dev)
    torch.cuda.synchronize()
    motion.LAUNCHES = 0
    codec = FusedVideoCodec(quantization_scale=1.0, search_range=4, device=dev).train(y[:2])
    before = motion.LAUNCHES
    qsyms, mvs, mv_bits, enc = codec.encode_gop(y_dev)
    gop_launches = motion.LAUNCHES - before
    p = codec.pack_gop(qsyms)
    rec, ok = codec.decode_gop(p.words, p.offsets, p.counts, mvs, H, W, p.block_words, p.cap)
    blob = codec.encode_to_container(y_dev)
    rec2, ok2 = FusedVideoCodec.decode_from_container(blob, device=dev)
    torch.cuda.synchronize()
    launches = motion.LAUNCHES

    check(bool(p.ok), "pack buckets failed")
    check(bool(ok) and bool(ok2), "entropy decode failed")
    check(tuple(rec.shape) == (T, H, W) and bool(torch.isfinite(rec).all()), "bad recon")
    err = float((rec - enc).abs().max())
    err2 = float((rec2 - enc).abs().max())
    mse = ((rec.cpu().numpy().astype(np.float64) - y) ** 2).mean(axis=(1, 2))
    psnr_y = float(np.mean(20 * np.log10(255.0 / np.sqrt(np.maximum(mse, 1e-12)))))
    bits = (p.totals + mv_bits).cpu().numpy()
    mean_bpp = float(bits.mean()) / (H * W)
    print(f"[gop] 1920x1088 T=8 q=1.0 sr=4: decoder vs encoder max abs {err:.3e}, "
          f"container decode max abs {err2:.3e}, PSNR-Y {psnr_y:.4f} dB, "
          f"mean bpp {mean_bpp:.6f}, container {len(blob)} bytes, "
          f"ME launches {gop_launches} in encode_gop, {launches} in the whole run")
    check(err < 1e-2, f"decoder mismatch {err}")
    check(err2 < 1e-2, f"container decode mismatch {err2}")
    check(psnr_y > 28.0, f"PSNR-Y collapsed: {psnr_y}")
    check(gop_launches >= T - 1, f"ME kernel launched {gop_launches} < {T - 1} times")

    stages = {"encode": [], "pack": [], "decode": []}
    oks = []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qsyms, mvs, mv_bits, _ = codec.encode_gop(y_dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p = codec.pack_gop(qsyms, check=False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rec, ok = codec.decode_gop(p.words, p.offsets, p.counts, mvs, H, W,
                                   p.block_words, p.cap)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        oks.append(ok & p.ok)
        if i >= 2:  # the first two are warm-up
            stages["encode"].append((t1 - t0) * 1e3)
            stages["pack"].append((t2 - t1) * 1e3)
            stages["decode"].append((t3 - t2) * 1e3)
    check(all(bool(o) for o in oks), "a timed GOP failed its pack or decode check")
    med = {k: float(np.median(v)) for k, v in stages.items()}
    total = sum(med.values())
    print(f"[gop] warm per-GOP ms (median of 6, synchronised): encode {med['encode']:.3f}, "
          f"pack {med['pack']:.3f}, decode {med['decode']:.3f}, total {total:.3f} "
          f"= {T * H * W / total / 1e3:.3f} Mpix/s encode+decode ({card})")
    print(f"[gop] per-GOP ms samples: {json.dumps(stages)}")

    # ------------------------------------------ 5. band kernel vs plain
    tile_err = 0
    for H5, W5, n_bands in [(1088, 1920, 4), (288, 352, 2)]:
        band_h = H5 // n_bands
        for sr in (2, 4, 7):
            ref = rng.integers(0, 256, (H5, W5)).astype(np.float32)
            cases = {
                "integer moved": (ref, np.roll(ref, (3, -2), (0, 1)) + rng.integers(-3, 4, (H5, W5))),
                "integer random": (ref, rng.integers(0, 256, (H5, W5))),
                "flat 128/128": (np.full((H5, W5), 128.0), np.full((H5, W5), 128.0)),
                "flat 100/120": (np.full((H5, W5), 100.0), np.full((H5, W5), 120.0)),
            }
            for name, (r_np, c_np) in cases.items():
                R5 = torch.from_numpy(r_np.astype(np.float32)).to(dev)
                C5 = torch.from_numpy(c_np.astype(np.float32)).to(dev)
                whole = motion.motion_search_cuda(R5, C5, sr)
                got = []
                for i in range(n_bands):
                    ext, band = band_of(R5, C5, i, band_h, sr)
                    a = motion.motion_search_tile_cuda(ext, band, i * band_h, H5, sr)
                    b = motion.motion_search_tile_reference(ext, band, i * band_h, H5, sr)
                    torch.cuda.synchronize()
                    bad = int((a != b).sum())
                    tile_err = max(tile_err, int((a - b).abs().max()))
                    check(bad == 0, f"band kernel != plain: {H5}x{W5} band {i} sr={sr} ({name}), "
                                    f"{bad} blocks differ")
                    got.append(a)
                same = torch.equal(torch.cat(got), whole)
                print(f"[band] {H5}x{W5} in {n_bands} bands of {band_h} rows, sr={sr}, {name}: "
                      f"every band equals plain; bands == whole-frame kernel {same}")
                check(same, f"bands != whole-frame kernel: {H5}x{W5} sr={sr} ({name})")

    band_h = H // 4
    ties_all = []
    got = []
    for i in range(4):
        ext, band = band_of(R, C, i, band_h, 4)  # phase 2's float fixture pair
        a = motion.motion_search_tile_cuda(ext, band, i * band_h, H, 4).cpu().numpy()
        b = motion.motion_search_tile_reference(ext, band, i * band_h, H, 4).cpu().numpy()
        ties_all += near_tie_gaps(fy[0], fy[1], a, b, 4, i * band_h)
        got.append(a)
    worst_band_gap = max((gap for *_, gap in ties_all), default=0.0)
    for blk, ssd, gap in ties_all:
        print(f"[band] near-tie block {blk}: ssd {ssd[0]!r} vs {ssd[1]!r}, gap {gap:.3e}")
    whole = motion.motion_search_cuda(R, C, 4).cpu().numpy()
    print(f"[band] float fixture {H}x{W} in 4 bands: {len(ties_all)} of {whole.size} differ "
          f"from plain, largest relative SSD gap {worst_band_gap:.3e}; bands == whole-frame "
          f"kernel {np.array_equal(np.concatenate(got), whole)}")
    check(worst_band_gap < 1e-5, "a float band mismatch is not a near-tie")
    check(np.array_equal(np.concatenate(got), whole), "float bands != whole-frame kernel")

    for label, r_np, c_np, sr, bh in order_cases:
        R2, C2 = torch.from_numpy(r_np).to(dev), torch.from_numpy(c_np).to(dev)
        H2 = R2.shape[0]
        bad = n = 0
        wide = sr == 0 or sr >= 16
        before = launch_counts()
        for i in range(H2 // bh):
            ext, band = band_of(R2, C2, i, bh, sr)
            a = motion.motion_search_tile_cuda(ext, band, i * bh, H2, sr)
            b = motion.motion_search_tile_kernel_order(ext, band, i * bh, H2, sr)
            bad += int((a != b).sum())
            n += a.numel()
            err = int((a - b).abs().max())
            if wide:
                wide_err = max(wide_err, err)
            else:
                tile_err = max(tile_err, err)
        after = launch_counts()
        check(after[3] - before[3] == (H2 // bh if wide else 0)
              and after[1] - before[1] == (0 if wide else H2 // bh),
              f"{label}: bands launched the wrong kernel")
        print(f"[band] kernel-order plain, {label} in {H2 // bh} bands of {bh} rows "
              f"({'wide_kernel' if wide else 'me_kernel'}): {bad} of {n} differ")
        check(bad == 0, f"band kernel != kernel-order plain: {label}")

    before = motion.TILE_LAUNCHES
    for row0, ext_rows, total_h in [(4, 24, 64), (56, 24, 64), (0, 26, 64), (-8, 24, 64)]:
        try:
            motion.motion_search_tile_cuda(torch.zeros((ext_rows, 32), device=dev),
                                           torch.zeros((16, 32), device=dev), row0, total_h, 4)
        except RuntimeError:
            continue
        fail(f"band kernel took row0={row0}, {ext_rows} reference rows, total_h={total_h}")
    check(motion.TILE_LAUNCHES == before, "a refused band call counted a launch")
    print("[band] refused row0=4, row0+Ht>total_h, 26 reference rows for sr=4, row0=-8")

    ext, band = band_of(R, C, 1, band_h, 4)
    for _ in range(3):
        motion.motion_search_tile_cuda(ext, band, band_h, H, 4)
        motion.motion_search_tile_reference(ext, band, band_h, H, 4)
    tile_us, tile_event_ms, tile_plain_ms = [], [], []
    for _ in range(2):  # alternate, kernel first then plain
        tile_us.append(float(np.mean(kernel_device_us(
            lambda: motion.motion_search_tile_cuda(ext, band, band_h, H, 4), 50, "me_kernel"))))
        tile_event_ms.append(cuda_ms(
            lambda: motion.motion_search_tile_cuda(ext, band, band_h, H, 4), 50))
        tile_plain_ms.append(cuda_ms(
            lambda: motion.motion_search_tile_reference(ext, band, band_h, H, 4), 10))
    band_ms, band_plain_ms = float(np.mean(tile_us)) / 1e3, float(np.mean(tile_plain_ms))
    band_bound = motion_search_bound(band_h + 8, band_h, W, 4)
    print(f"[band] {band_h}x{W} band sr=4 kernel {tile_us} us device (mean of 50 launches), "
          f"{tile_event_ms} ms per call (CUDA events), plain {tile_plain_ms} ms; bound "
          f"{band_bound[0] * 1e3:.3f} us ({band_bound[1]}), {band_bound[0] / band_ms:.3f} of it "
          f"({card})")
    for sr in (8, 15):
        ext_s, band_s = band_of(R, C, 1, band_h, sr)
        motion.motion_search_tile_cuda(ext_s, band_s, band_h, H, sr)
        us = float(np.mean(kernel_device_us(
            lambda: motion.motion_search_tile_cuda(ext_s, band_s, band_h, H, sr), 20,
            "me_kernel")))
        bound = motion_search_bound(band_h + 2 * sr, band_h, W, sr)
        print(f"[band] {band_h}x{W} band sr={sr} kernel {us:.3f} us device (mean of 20 launches); "
              f"bound {bound[0] * 1e3:.3f} us ({bound[1]}), {bound[0] * 1e3 / us:.3f} of it "
              f"({card})")
    for sr in WIDE_RANGES:
        ext_s, band_s = band_of(R, C, 1, band_h, sr)
        motion.motion_search_tile_cuda(ext_s, band_s, band_h, H, sr)
        us = float(np.mean(kernel_device_us(
            lambda: motion.motion_search_tile_cuda(ext_s, band_s, band_h, H, sr), 10,
            "wide_kernel")))
        bound = motion_search_bound(band_h + 2 * sr, band_h, W, sr)
        print(f"[band] {band_h}x{W} band sr={sr} wide_kernel {us:.3f} us device (mean of 10 "
              f"launches); bound {bound[0] * 1e3:.3f} us ({bound[1]}; "
              f"{valid_candidate_share(band_h, W, sr, band_h, H):.4f} of the candidates in the "
              f"frame), {bound[0] * 1e3 / us:.4f} of it ({card})")

    # ------------------------------------- 6. the sharded path at full width
    from ivclab_tpu_torch import parallel

    T6, n_gop, n_tile = 16, 2, 4
    gop_len, band_h = T6 // n_gop, H // n_tile
    y6 = luma(fixtures.video("bench", T6, (H, W)))
    y6_dev = torch.from_numpy(y6).to(dev)
    fused = FusedVideoCodec(quantization_scale=1.0, search_range=4, device=dev).train(y6[:2])
    enc6 = [fused.encode_gop(y6_dev[g * gop_len:(g + 1) * gop_len]) for g in range(n_gop)]
    packs = [fused.pack_gop(e[0]) for e in enc6]  # GOP 0 picks the buckets
    buckets = fused._buckets
    packs = [fused.pack_gop(e[0]) for e in enc6]  # both GOPs under the final buckets
    check(fused._buckets == buckets, "pack buckets moved between GOPs")
    cap, bw, gw = buckets
    mesh = parallel.make_mesh(n_gop, n_tile, device=dev)
    step = parallel.build_sharded_video_codec(mesh, fused, gop_len, band_h, W, cap, gw, bw)
    torch.cuda.synchronize()
    motion.LAUNCHES = motion.TILE_LAUNCHES = 0
    streams = step(parallel.shard_frames(y6_dev, mesh))
    torch.cuda.synchronize()
    tile_launches, whole_launches = motion.TILE_LAUNCHES, motion.LAUNCHES
    print(f"[shard] {W}x{H} T={T6} mesh gop={n_gop} x tile={n_tile} (bands of {band_h} rows) "
          f"q=1.0 sr=4 buckets {buckets}: band-kernel launches {tile_launches}, "
          f"whole-frame launches {whole_launches}")
    check(tile_launches >= n_gop * (gop_len - 1) * n_tile,
          f"band kernel launched {tile_launches} < {n_gop * (gop_len - 1) * n_tile} times")

    blobs = parallel.assemble_video_payloads(fused, streams, gop_len)
    for g, (p6, (_, mvs6, _, rec6)) in enumerate(zip(packs, enc6)):
        sl = slice(g * gop_len, (g + 1) * gop_len)
        for field in ("words", "offsets", "counts", "group_bits", "totals"):
            got, want = getattr(streams, field)[sl], getattr(p6, field)
            same = got.shape == want.shape and torch.equal(got.to(want.dtype), want)
            if not same and got.shape == want.shape:
                first = torch.nonzero(got.to(want.dtype) != want)[0].tolist()
                print(f"[shard] GOP {g} {field}: first difference at {first}")
            check(same, f"GOP {g}: sharded {field} != fused pack")
        check(torch.equal(streams.mvs[sl], mvs6), f"GOP {g}: sharded mvs != fused")
        rec_gap = float((streams.recons[sl] - rec6).abs().max())
        check(torch.equal(streams.recons[sl], rec6), f"GOP {g}: sharded recons != fused "
                                                     f"(max abs {rec_gap})")
        want_blob = fused.container_from_packed(p6, mvs6, (gop_len, H, W))
        check(blobs[g] == want_blob, f"GOP {g}: assembled bytes != container_from_packed")
        rec_c, ok_c = FusedVideoCodec.decode_from_container(blobs[g], device=dev)
        err_c = float((rec_c - streams.recons[sl]).abs().max())
        print(f"[shard] GOP {g}: words, offsets, counts, group bits, totals, mvs and recons "
              f"equal the fused pack; {len(blobs[g])} assembled bytes == container_from_packed; "
              f"container decode ok {bool(ok_c)}, max abs {err_c:.3e}")
        check(bool(ok_c) and err_c < 1e-2, f"GOP {g}: container decode failed ({err_c})")

    def fused_pair():
        for g in range(n_gop):
            q6, *_ = fused.encode_gop(y6_dev[g * gop_len:(g + 1) * gop_len])
            fused.pack_gop(q6, check=False)

    times = {"sharded": [], "fused": []}
    for i in range(6):  # alternate; the first round is warm-up
        for name, fn in (("sharded", lambda: step(parallel.shard_frames(y6_dev, mesh))),
                         ("fused", fused_pair)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                times[name].append((time.perf_counter() - t0) * 1e3)
    shard_med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[shard] warm ms per GOP pair (median of 5, synchronised): sharded step "
          f"{shard_med['sharded']:.3f}, fused encode+pack {shard_med['fused']:.3f} ({card})")
    print(f"[shard] ms samples: {json.dumps(times)}")

    # --------------------------------- 7. the intra codec at full width
    intra_phase(dev, card)

    # ---------------------------------------------------------- 8. profile
    profile_line(f"encode_gop 1920x1088 T={T}", lambda: codec.encode_gop(y_dev))
    profile_line(f"sharded step {W}x{H} T={T6} gop={n_gop} x tile={n_tile}",
                 lambda: step(parallel.shard_frames(y6_dev, mesh)))

    # ------------------------- 9. the adaptive video codec at full width
    launches += adaptive_phase(dev, card, y, rgb)

    # ------------------------ 10. the sharded adaptive encoder at full width
    tile_launches += sharded_adaptive_phase(dev, card, y6)

    # ---------------------------- 11. the ch1/ch2 library at full width
    library_phase(dev, card)

    # ------------------------------------------- 12. the CLI on the card
    cli_whole, cli_band, wide_launches = cli_phase(card)
    launches += cli_whole
    tile_launches += cli_band
    check(wide_launches > 0, "the CLI runs launched no wide_kernel")

    print(json.dumps({"kernels": [{
        "name": "motion_search",
        "route": "cuda",
        "source": "ivclab_tpu_torch/csrc/motion_search.cu",
        "replaces": "ivclab_tpu/ops/motion_pallas.py:40",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": me_ms,
        "plain_ms": me_plain_ms,
        "bound_ms": me_bound[0],
        "bound_by": me_bound[1],
        "library_ms": None,  # no single PyTorch call computes a full-search argmin
    }, {
        "name": "motion_search_tile",
        "route": "cuda",
        "source": "ivclab_tpu_torch/csrc/motion_search.cu",
        "replaces": "ivclab_tpu/ops/motion_pallas.py:98",
        "launches": tile_launches,
        "max_abs_err": tile_err,
        "ms": band_ms,
        "plain_ms": band_plain_ms,
        "bound_ms": band_bound[0],
        "bound_by": band_bound[1],
        "library_ms": None,
    }, {
        "name": "motion_search_wide",
        "route": "cuda",
        "source": "ivclab_tpu_torch/csrc/motion_search.cu",
        "replaces": "ivclab_tpu/ops/motion_pallas.py:40",
        "launches": wide_launches,
        "max_abs_err": wide_err,
        "ms": wide_ms,  # 1088x1920 at sr=16
        "plain_ms": wide_plain_ms,
        "bound_ms": wide_bound[0],
        "bound_by": wide_bound[1],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
