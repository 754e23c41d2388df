"""The system under test for configurations naming ``FusedVideoCodec``:
``ivclab_tpu_torch/models/fastvideo.py::FusedVideoCodec``, trained once on
the clip's first two frames, its sticky pack buckets settled over the whole
clip. Every call into the port runs inside one of the harness's spans."""

from __future__ import annotations

import torch


class Program:
    def __init__(self, cfg: dict, device, spans):
        from ivclab_tpu_torch.models.fastvideo import FusedVideoCodec

        self.Codec = FusedVideoCodec
        self.codec = FusedVideoCodec(quantization_scale=cfg["q"], search_range=cfg["sr"],
                                     device=device)
        self.device = torch.device(device)
        self.span = spans

    def prepare(self, clip: torch.Tensor, gops: list[torch.Tensor]) -> None:
        self.codec.train(clip[:2])
        # settle the sticky pack buckets: every GOP of the clip must pack
        # with one set, so no GOP of the window has to re-pack
        for _ in range(4):
            before = self.codec._buckets
            for g in gops:
                self.codec.pack_gop(self.codec.encode_gop(g)[0], check=True)
            if self.codec._buckets == before:
                return
        raise RuntimeError("the fused codec's pack buckets do not settle on this clip")

    def roundtrip(self, gop: torch.Tensor):
        """encode -> pack (no host read) -> decode: outputs and a device ok."""
        c = self.codec
        _, H, W = gop.shape
        with self.span("cb.encode_gop"):
            qsyms, mvs, _, _ = c.encode_gop(gop)
        with self.span("cb.pack_gop"):
            p = c.pack_gop(qsyms, check=False)
        with self.span("cb.decode_gop"):
            recons, ok = c.decode_gop(p.words, p.offsets, p.counts, mvs, H, W,
                                      p.block_words, p.cap)
        out = {"qsyms": qsyms, "mvs": mvs, "totals": p.totals, "recons": recons}
        return out, ok & p.ok, {"cap": p.cap}

    def encode(self, gop: torch.Tensor) -> bytes:
        return self.codec.encode_to_container(gop)

    def decode(self, blob: bytes):
        with self.span("cb.decode_from_container"):
            recons, ok = self.Codec.decode_from_container(blob, device=self.device)
        return {"recons": recons}, ok, {}
