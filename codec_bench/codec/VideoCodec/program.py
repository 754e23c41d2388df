"""The system under test for configurations naming ``VideoCodec``:
``ivclab_tpu_torch/models/videocodec.py::VideoCodec`` under the
configuration's codebook policy; under ``per-frame`` every GOP builds its
codebooks on the host. Every call into the port runs inside one of the
harness's spans."""

from __future__ import annotations

import torch


class Program:
    def __init__(self, cfg: dict, device, spans):
        from ivclab_tpu_torch.models.videocodec import VideoCodec

        self.Codec = VideoCodec
        self.codec = VideoCodec(quantization_scale=cfg["q"], codebook_policy=cfg["policy"],
                                search_range=cfg["sr"], device=device)
        self.device = torch.device(device)
        self.span = spans

    def prepare(self, clip: torch.Tensor, gops: list[torch.Tensor]) -> None:
        pass  # nothing is trained ahead: every GOP builds its own codebooks

    def roundtrip(self, gop: torch.Tensor):
        """bytes out -> frames back on the device."""
        with self.span("cb.encode_to_container"):
            blob = self.codec.encode_to_container(gop)
        out, ok, info = self.decode(blob)
        out["blob"] = blob
        return out, ok, info

    def encode(self, gop: torch.Tensor) -> bytes:
        return self.codec.encode_to_container(gop)

    def decode(self, blob: bytes):
        with self.span("cb.decode_from_container"):
            recons, oks = self.Codec.decode_from_container(blob, return_device=True,
                                                           device=self.device)
        return {"recons": recons}, oks.all(), {}
