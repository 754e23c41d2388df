"""The system under test for the configuration ``StillTestCodec``, a
still-image codec that exists only in the benchmark's tests, built from
the plain reference and its judge's helpers: RGB to JFIF YCbCr, each 4:4:4
plane through the 8x8 transform and quantiser under its own table and
zero-run, each plane's bits under a Huffman code of its own tokens; the
decoder reads the tokens back to blocks, dequantises each plane with its
own table and maps back to RGB."""

from __future__ import annotations

import torch

from codec_bench.reference import codec as ref
from codec_bench.tests.still_codec import judge


class Program:
    def __init__(self, cfg: dict, device, spans):
        self.span = spans
        self.tables = judge.transforms(cfg["q"], torch.device(device))

    def prepare(self, clip: torch.Tensor, images: list[torch.Tensor]) -> None:
        pass

    def roundtrip(self, image: torch.Tensor):
        """RGB image -> symbols and bits a plane -> RGB image."""
        H, W, _ = image.shape
        with self.span("cb.encode"):
            planes = judge.to_ycc(image)
            qsyms = torch.stack([tr.quantise(p) for tr, p in zip(self.tables, planes)])
            totals = torch.as_tensor(judge.own_bits(qsyms))
        with self.span("cb.decode"):
            blocks = [ref.zerorun_blocks(*ref.zerorun_tokens(q)) for q in qsyms]
            planes = [tr.reconstruct(b, H, W) for tr, (b, _) in zip(self.tables, blocks)]
            recons = judge.to_rgb(torch.stack(planes))
            ok = torch.stack([good.all() for _, good in blocks]).all()
        return {"qsyms": qsyms, "totals": totals, "recons": recons}, ok, {}
