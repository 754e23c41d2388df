"""The system under test for configurations naming ``IntraCodec``:
``ivclab_tpu_torch/models/intracodec.py::IntraCodec``, the still-image
codec (YCbCr, 8x8 DCT, a quantiser table a plane, zero-run, one canonical
Huffman code) through its IVC1 container. Its codebook is trained once in
set-up on the clip's first image, as the course's RD sweep trains once
before coding, over the alphabet of every symbol an 8-bit image can
produce at the configuration's ``q`` (``IntraCodec.full_bounds``), so that
no symbol of another image lies outside it. A round trip's outputs name
that image (``trained_on``), on which the judge trains the reference's own
code. Every call into the port runs inside one of the harness's spans."""

from __future__ import annotations

import torch


class Program:
    def __init__(self, cfg: dict, device, spans):
        from ivclab_tpu_torch.models.intracodec import IntraCodec

        self.Codec = IntraCodec
        self.codec = IntraCodec(quantization_scale=cfg["q"], device=device)
        self.device = torch.device(device)
        self.span = spans

    def prepare(self, clip: torch.Tensor, images: list[torch.Tensor]) -> None:
        self.trained_on = clip[0]
        self.codec.train_huffman_from_image(self.trained_on, bounds=self.codec.full_bounds())

    def roundtrip(self, image: torch.Tensor):
        """RGB image -> IVC1 bytes -> RGB image back on the device."""
        with self.span("cb.encode_to_container"):
            blob = self.codec.encode_to_container(image)
        out, ok, info = self.decode(blob)
        out["blob"], out["trained_on"] = blob, self.trained_on
        return out, ok, info

    def encode(self, image: torch.Tensor) -> bytes:
        return self.codec.encode_to_container(image)

    def decode(self, blob: bytes):
        with self.span("cb.decode_from_container"):
            recons, ok = self.Codec.decode_from_container(blob, device=self.device,
                                                          return_device=True)
        return {"recons": recons}, ok, {}
