"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped (the CPU), the rest of the run is
driven as on the card, and the port is broken where it produces its
output, once for each fault the cells can have (none of them runs across
chips, so no exchange can be left out)."""

import json

import pytest
import torch

from codec_bench import harness
from codec_bench.tests.tiny import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _alter_token(monkeypatch, cell):
    """A token altered where it is produced: one symbol of the round trip,
    one bit of every container's last frame."""
    from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec
    from ivclab_tpu_torch.models.videocodec import VideoCodec

    enc = FusedVideoCodec.encode_gop

    def encode_gop(self, frames):
        qsyms, mvs, bits, recons = enc(self, frames)
        qsyms = qsyms.clone()
        qsyms[-1, 7, 0] += 1
        return qsyms, mvs, bits, recons

    def flipping(original):
        def encode_to_container(self, frames):
            blob = bytearray(original(self, frames))
            blob[len(blob) - 40] ^= 0x10
            return bytes(blob)
        return encode_to_container

    monkeypatch.setattr(FusedVideoCodec, "encode_gop", encode_gop)
    monkeypatch.setattr(FusedVideoCodec, "encode_to_container",
                        flipping(FusedVideoCodec.encode_to_container))
    monkeypatch.setattr(VideoCodec, "encode_to_container",
                        flipping(VideoCodec.encode_to_container))


def _drop_half(monkeypatch, cell):
    """Half of the batch left out: the decoders return the first half of a
    GOP's frames and zeros for the rest."""
    from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec
    from ivclab_tpu_torch.models.videocodec import VideoCodec

    def halved(recons):
        out = recons.clone()
        out[out.shape[0] // 2:] = 0
        return out

    dec = FusedVideoCodec.decode_gop
    monkeypatch.setattr(FusedVideoCodec, "decode_gop",
                        lambda self, *a, **k: (halved(dec(self, *a, **k)[0]), dec(self, *a, **k)[1]))
    vdec = VideoCodec.decode_from_container.__func__

    def decode_from_container(cls, blob, return_device=False, device="cuda"):
        recons, oks = vdec(cls, blob, return_device=True, device=device)
        return halved(recons), oks

    monkeypatch.setattr(VideoCodec, "decode_from_container", classmethod(decode_from_container))


def _state_unchanged(monkeypatch, cell):
    """A step that returns its state unchanged: motion compensation hands
    back the reference frame unmoved, in the encoder and the decoder alike
    (the port stays consistent with itself)."""
    from ivclab_tpu_torch.models import fastvideo, videocodec

    def unmoved(ref, mv, sr=4):
        return ref.to(torch.float32).clone()

    monkeypatch.setattr(fastvideo, "motion_compensate", unmoved)
    monkeypatch.setattr(videocodec, "motion_compensate", unmoved)


FAULTS = {"alter_token": _alter_token, "drop_half": _drop_half,
          "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(tiny, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch, cell)
    r = harness.run(tiny, cell, 2**31 + 5, 1.5, False, device="cpu", log=lambda s: None)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
