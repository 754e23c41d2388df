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
   float fixture frames every mismatch must be a verified near-tie; times
   both at 1088x1920;
3. cross-device integer exactness: one set of symbols and motion fields
   packed and serialized on CUDA and on the CPU gives identical bytes, and
   the two decodes agree;
4. the main path at full width: train, encode, pack and decode an 8-frame
   1920x1088 GOP through ``FusedVideoCodec`` on CUDA and through the IVC1
   container, with the decoder within 1e-2 of the encoder and PSNR-Y above
   28 dB; counts the kernel's launches over that run and times each stage.

The line before the last is a JSON list of the kernels with their launch
counts and times; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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


def cuda_ms(fn, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
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
    y = luma(fixtures.video("bench", T, (H, W)))
    fy = y[:2]
    R, C = torch.from_numpy(fy[0]).to(dev), torch.from_numpy(fy[1]).to(dev)
    a = motion.motion_search_cuda(R, C, 4).cpu().numpy()
    b = motion.motion_search_reference(R, C, 4).cpu().numpy()
    mism = np.argwhere(a != b)
    worst_gap = 0.0
    ref64, cur64 = fy[0].astype(np.float64), fy[1].astype(np.float64)
    for by, bx in mism:
        blk = cur64[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8]
        ssd = []
        for idx in (a[by, bx], b[by, bx]):
            dy, dx = idx // 9 - 4, idx % 9 - 4
            y0, x0 = by * 8 + dy, bx * 8 + dx
            ssd.append(float(((blk - ref64[y0:y0 + 8, x0:x0 + 8]) ** 2).sum()))
        gap = abs(ssd[0] - ssd[1]) / max(ssd[0], ssd[1], 1.0)
        worst_gap = max(worst_gap, gap)
        print(f"[me] near-tie block ({by}, {bx}): kernel {a[by, bx]} ssd {ssd[0]!r}, "
              f"plain {b[by, bx]} ssd {ssd[1]!r}, relative gap {gap:.3e}")
    print(f"[me] float fixture 1088x1920: {len(mism)} of {a.size} differ, "
          f"largest relative SSD gap {worst_gap:.3e}")
    check(worst_gap < 1e-5, "a float mismatch is not a near-tie")

    for _ in range(3):
        motion.motion_search_cuda(R, C, 4)
        motion.motion_search_reference(R, C, 4)
    kernel_ms, plain_ms = [], []
    for _ in range(2):  # alternate, kernel first then plain
        kernel_ms.append(cuda_ms(lambda: motion.motion_search_cuda(R, C, 4), 50))
        plain_ms.append(cuda_ms(lambda: motion.motion_search_reference(R, C, 4), 10))
    me_ms, me_plain_ms = float(np.mean(kernel_ms)), float(np.mean(plain_ms))
    print(f"[me] 1088x1920 sr=4 kernel {kernel_ms} ms, plain {plain_ms} ms ({card})")

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

    print(json.dumps({"kernels": [{
        "name": "motion_search",
        "route": "cuda",
        "source": "ivclab_tpu_torch/csrc/motion_search.cu",
        "replaces": "ivclab_tpu/ops/motion_pallas.py:40",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": me_ms,
        "plain_ms": me_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
