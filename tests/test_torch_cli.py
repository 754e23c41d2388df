"""The port's CLI (``python -m ivclab_tpu_torch.cli``) against the JAX
package's (``ivclab_tpu/cli.py``), both run in this process on the same
arguments; the port's gets ``--device cpu``.

Sizes: fixture images (lena_small 256x256 RGB), 3 foreman frames at 288x352
(CIF) for each codebook policy and search ranges 4, 0 and 16, 4 frames for
the mesh runs, and a directory of four 128x256 PNG frames written by the
test for the tile axis. What must match:

- ``.ivc`` container and IVCS stream files: byte for byte;
- JSON reports: equal, except the file name (``output``), the stage times
  (``trace``, which only ``--trace`` adds) and PSNR, which both packages
  take as a float32 mean over the pixels in their own summation order:
  within 0.001 dB;
- decoded frames (``decode-video``, ``decode-image``): the reconstructions
  agree within the codec's 1e-2 bound, so a value next to k + 1/2 may round
  to the other 8-bit level: every pixel within 1 level, and at most 1 in
  10,000 pixels differing;
- ``rd-sweep --kind dpcm``: the port's FIR tap sums and FFT carry their
  own tolerances (``tests/test_torch_predictive.py``), so bpp within 0.5%
  and PSNR within 0.05 dB; ``--kind video``: bpp equal, PSNR within 0.001 dB.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ivclab_tpu import cli as jcli
from ivclab_tpu_torch import cli as tcli

REPO = Path(__file__).resolve().parent.parent
PSNR_TOL = 1e-3  # dB: a float32 mean over pixels, summed in another order


def run(capsys, main, *argv):
    """Run one CLI in this process; its last JSON line."""
    main(list(argv))
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def run_both(capsys, tmp_path, *argv):
    """Both CLIs on ``argv``; ``{}`` in an argument becomes a per-CLI path
    under tmp_path. Returns (JAX report, port report, JAX paths, port paths)."""
    paths = {}
    out = {}
    for name, main, prefix in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        p = []
        args = []
        for a in argv:
            if "{}" in a:
                p.append(tmp_path / a.format(name))
                args.append(str(p[-1]))
            else:
                args.append(a)
        paths[name] = p
        out[name] = run(capsys, main, *prefix, *args)
    return out["jax"], out["torch"], paths["jax"], paths["torch"]


def assert_same_report(j: dict, t: dict, psnr_keys=("mean_psnr_y_db", "psnr_db")):
    j, t = dict(j), dict(t)
    for key in ("output", "trace"):
        j.pop(key, None)
        t.pop(key, None)
    for key in psnr_keys:
        if key in j:
            assert abs(j.pop(key) - t.pop(key)) <= PSNR_TOL, key
    assert t == j


def assert_same_sharded_report(capsys, j: dict, t: dict, stream: Path, policy: str):
    """A mesh run's report against the JAX CLI's single-device report of the
    same frames. Both CLIs' sharded ``first-p-frame`` reports give each GOP
    container's ``frame_bits`` (residual bits only, ``cli.py:310``) where
    the single-device report adds the motion bits: those two keys are held
    to the stream's ``info`` instead."""
    j, t = dict(j), dict(t)
    if policy == "first-p-frame":
        info = run(capsys, jcli.main, "info", str(stream))
        want = [b for g in info["gops"] for b in g["per_frame_bits"]]
        H, W = info["gops"][0]["shape"][1:]
        assert t.pop("per_frame_bits") == want
        assert t.pop("mean_bpp") == round(float(np.mean(want)) / (H * W), 4)
        j.pop("per_frame_bits"), j.pop("mean_bpp")
    assert_same_report(j, t)


def assert_levels_close(port: np.ndarray, ref: np.ndarray):
    """uint8 frames: every pixel within 1 level, at most 1e-4 of them off."""
    assert port.shape == ref.shape and port.dtype == ref.dtype
    diff = np.abs(port.astype(np.int64) - ref.astype(np.int64))
    assert diff.max(initial=0) <= 1
    assert (diff > 0).sum() <= 1e-4 * diff.size


def test_encode_image_info_and_decode_image(capsys, tmp_path):
    j, t, jp, tp = run_both(capsys, tmp_path, "encode-image", "fixture:lena_small", "{}.ivc",
                            "--q", "0.5")
    assert t == j
    assert tp[0].read_bytes() == jp[0].read_bytes()
    ji = run(capsys, jcli.main, "info", str(jp[0]))
    ti = run(capsys, tcli.main, "--device", "cpu", "info", str(tp[0]))
    assert ti == ji and ti["layout"] == "grouped" and ti["shape"] == [256, 256, 3]
    j, t, jpng, tpng = run_both(capsys, tmp_path, "decode-image", str(jp[0]), "{}.png")
    assert t == j == {"shape": [256, 256, 3]}
    from PIL import Image

    assert_levels_close(np.asarray(Image.open(tpng[0])), np.asarray(Image.open(jpng[0])))


def test_roundtrip_image(capsys, tmp_path):
    j, t, _, _ = run_both(capsys, tmp_path, "roundtrip-image", "fixture:lena_small", "--q", "0.5")
    assert_same_report(j, t)
    assert t["psnr_db"] > 26


@pytest.mark.parametrize("sr", ["4", "0", "16"])
@pytest.mark.parametrize("policy", ["first-p-frame", "per-frame", "adaptive"])
def test_encode_video_stream_bytes(capsys, tmp_path, policy, sr):
    """3 CIF foreman frames at q=2.0: the IVCS stream bytes and the report
    equal the JAX CLI's, at the default search range and at 0 and 16 (which
    the card serves with its wide kernel)."""
    j, t, jp, tp = run_both(capsys, tmp_path, "encode-video", "fixture:foreman", "{}.ivc",
                            "--frames", "3", "--q", "2.0", "--search-range", sr,
                            "--codebook-policy", policy)
    assert tp[0].read_bytes() == jp[0].read_bytes()
    assert_same_report(j, t)
    assert t["frames"] == 3 and len(t["per_frame_bits"]) == 3


def test_encode_video_trace_reports_every_stage(capsys, tmp_path):
    out = run(capsys, tcli.main, "--device", "cpu", "--trace", "encode-video", "fixture:foreman",
              str(tmp_path / "s.ivc"), "--frames", "2", "--q", "2.0")
    assert sorted(out["trace"]) == ["decode-check", "encode", "pack", "serialize", "train"]
    for row in out["trace"].values():
        assert row["calls"] == 1 and row["total_s"] >= 0 and "mean_ms" in row
    # each stage is a span of the port's recorder, around the port's own spans
    names = out["spans"]["names"]
    assert set(out["trace"]) | {"ivc.fused.encode_gop", "ivc.fused.pack_gop",
                                "ivc.pack.map", "ivc.pack.deposit"} <= set(names)
    assert names["pack"]["calls"] == 1 and names["ivc.fused.pack_gop"]["host_ms"] >= 0


@pytest.mark.parametrize("policy", ["first-p-frame", "per-frame"])
def test_mesh_gop_run_equals_the_single_device_bytes(capsys, tmp_path, policy):
    """``--mesh-gop 2 --mesh-tile 1`` on an in-process CPU mesh: the same
    stream as the JAX CLI's single-device run of the same 4 frames in GOPs
    of 2."""
    common = ["fixture:foreman", "--frames", "4", "--gop", "2", "--q", "2.0",
              "--codebook-policy", policy]
    j = run(capsys, jcli.main, "encode-video", common[0], str(tmp_path / "j.ivc"), *common[1:])
    t = run(capsys, tcli.main, "--device", "cpu", "encode-video", common[0],
            str(tmp_path / "t.ivc"), *common[1:], "--mesh-gop", "2", "--mesh-tile", "1")
    assert (tmp_path / "t.ivc").read_bytes() == (tmp_path / "j.ivc").read_bytes()
    assert_same_sharded_report(capsys, j, t, tmp_path / "j.ivc", policy)
    assert t["gops"] == 2


@pytest.mark.parametrize("policy", ["first-p-frame", "per-frame"])
def test_mesh_tile_run_on_a_png_directory(capsys, tmp_path, policy):
    """Four 128x256 PNG frames written here; ``--mesh-tile 2`` splits each
    into two 64-row bands (256 blocks, 16 pack groups, a band) and the
    stream equals the JAX CLI's single-device run on the same directory."""
    from PIL import Image

    from ivclab_tpu_torch.utils import fixtures

    src = tmp_path / "frames"
    src.mkdir()
    for i, frame in enumerate(fixtures.video("pngdir", num_frames=4, shape=(128, 256))):
        Image.fromarray(frame).save(src / f"f{i:02d}.png")
    common = ["--frames", "4", "--gop", "4", "--q", "1.0", "--codebook-policy", policy]
    j = run(capsys, jcli.main, "encode-video", str(src), str(tmp_path / "j.ivc"), *common)
    t = run(capsys, tcli.main, "--device", "cpu", "encode-video", str(src),
            str(tmp_path / "t.ivc"), *common, "--mesh-gop", "1", "--mesh-tile", "2")
    assert (tmp_path / "t.ivc").read_bytes() == (tmp_path / "j.ivc").read_bytes()
    assert_same_sharded_report(capsys, j, t, tmp_path / "j.ivc", policy)


def test_mesh_refuses_what_does_not_split(capsys, tmp_path):
    with pytest.raises(SystemExit, match="do not fill"):
        tcli.main(["--device", "cpu", "encode-video", "fixture:foreman", str(tmp_path / "x.ivc"),
                   "--frames", "3", "--mesh-gop", "2", "--mesh-tile", "1"])
    with pytest.raises(SystemExit, match="8-aligned bands"):
        tcli.main(["--device", "cpu", "encode-video", "fixture:foreman", str(tmp_path / "x.ivc"),
                   "--frames", "2", "--mesh-gop", "1", "--mesh-tile", "5"])


@pytest.mark.parametrize("policy", ["first-p-frame", "per-frame"])
def test_decode_video_and_stream_info(capsys, tmp_path, policy):
    """A two-GOP stream of 4 frames: ``decode-video`` to ``.npy`` and
    ``info`` on the stream, both CLIs reading the JAX CLI's file."""
    stream = tmp_path / "s.ivc"
    run(capsys, jcli.main, "encode-video", "fixture:foreman", str(stream), "--frames", "4",
        "--gop", "2", "--q", "2.0", "--codebook-policy", policy)
    j, t, jp, tp = run_both(capsys, tmp_path, "decode-video", str(stream), "{}.npy")
    assert t == j == {"frames": 4, "shape": [288, 352]}
    assert_levels_close(np.load(tp[0]), np.load(jp[0]))
    ji = run(capsys, jcli.main, "info", str(stream))
    ti = run(capsys, tcli.main, "--device", "cpu", "info", str(stream))
    assert ti == ji and ti["kind"] == "video-stream" and len(ti["gops"]) == 2


def test_rd_sweep_dpcm(capsys, tmp_path):
    j, t, _, _ = run_both(capsys, tmp_path, "rd-sweep", "--kind", "dpcm")
    assert t["kind"] == j["kind"] == "dpcm"
    qs = [1, 2, 4, 8, 16, 32, 64]
    assert [p["q"] for p in t["points"]] == [p["q"] for p in j["points"]] == qs
    for pt, pj in zip(t["points"], j["points"]):
        assert abs(pt["bpp"] - pj["bpp"]) <= 5e-3 * pj["bpp"]
        assert abs(pt["psnr_db"] - pj["psnr_db"]) <= 0.05
    bpps = [p["bpp"] for p in t["points"]]
    assert bpps == sorted(bpps, reverse=True)  # coarser quantisation, fewer bits


def test_rd_sweep_video(capsys, tmp_path):
    j, t, _, _ = run_both(capsys, tmp_path, "rd-sweep", "--kind", "video", "--frames", "3")
    assert len(t["points"]) == len(j["points"]) == 10
    for pt, pj in zip(t["points"], j["points"]):
        assert_same_report(pj, pt)


def _stream_bytes(tmp_path) -> bytes:
    blobs = [b"IVC1" + bytes(range(20)), b"", b"\x07" * 33]
    jcli.write_video_stream(tmp_path / "j.ivcs", blobs)
    tcli.write_video_stream(tmp_path / "t.ivcs", blobs)
    data = (tmp_path / "t.ivcs").read_bytes()
    assert data == (tmp_path / "j.ivcs").read_bytes()
    assert tcli.read_video_stream(tmp_path / "t.ivcs") == blobs
    return data


def test_ivcs_truncation_fuzzing(tmp_path):
    """Every prefix of a stream, and streams with a hostile GOP count or
    length: the port raises the JAX CLI's ValueError, with its message, or
    returns its blobs."""
    data = _stream_bytes(tmp_path)
    rng = np.random.default_rng(7)
    cases = [data[:n] for n in range(len(data))]
    for _ in range(40):  # random count and length fields
        b = bytearray(data)
        at = int(rng.choice([6, 10, 10 + 8 + 24]))
        b[at:at + 4] = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
        cases.append(bytes(b))
    cases.append(b"XXXX" + data[4:])
    checked = 0
    for i, case in enumerate(cases):
        path = tmp_path / f"c{i}.ivcs"
        path.write_bytes(case)
        outcome = []
        for mod in (jcli, tcli):
            try:
                outcome.append(("ok", mod.read_video_stream(path)))
            except ValueError as e:
                outcome.append(("ValueError", str(e)))
        assert outcome[1] == outcome[0], (i, outcome)
        checked += outcome[0][0] == "ValueError"
    assert checked >= len(data)  # every proper prefix is refused


def test_cli_help_imports_neither_jax_nor_the_jax_package():
    probe = (
        "import runpy, sys\n"
        "sys.argv = ['ivclab_tpu_torch.cli', '--help']\n"
        "try:\n"
        "    runpy.run_module('ivclab_tpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ivclab_tpu')]\n"
        "print('IMPORTED', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "IMPORTED []" in out.stdout
    for cmd in ("encode-image", "decode-image", "roundtrip-image", "encode-video",
                "decode-video", "rd-sweep", "info", "--device"):
        assert cmd in out.stdout
    help_run = subprocess.run([sys.executable, "-m", "ivclab_tpu_torch.cli", "--help"], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
    assert help_run.returncode == 0 and "encode-video" in help_run.stdout


def test_subcommands_and_flags_match_the_jax_cli():
    import argparse

    def shape(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {name: sorted((tuple(a.option_strings), a.default) for a in p._actions
                             if a.option_strings and a.dest != "help")
                for name, p in sub.choices.items()}

    assert shape(tcli.build_parser()) == shape(jcli.build_parser())
    top = {a.dest: a.default for a in tcli.build_parser()._actions if a.option_strings}
    assert top["device"] == "cuda" and top["trace"] is False


def test_the_default_device_refuses_without_a_card(tmp_path):
    """Without ``--device`` every codec is built on the card; with none the
    first tensor placed raises from torch, and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises((RuntimeError, AssertionError)):
        tcli.main(["encode-image", "fixture:lena_small", str(tmp_path / "x.ivc")])
    with pytest.raises((RuntimeError, AssertionError)):
        tcli.main(["encode-video", "fixture:foreman", str(tmp_path / "x.ivc"), "--frames", "2"])
    assert not (tmp_path / "x.ivc").exists()
