"""Seeded RGB still images, made on the device in a few large calls.

The design of ``content.py`` in three colours: luma of multi-octave value
noise with hard-edged shapes and fine texture; two chroma planes that
follow the luma by a slope drawn for each image, plus smooth value noise
of their own, so chroma is correlated with luma but not equal to it; the
three planes mapped to RGB through the JFIF (BT.601 full-range) matrix,
sensor noise on every channel, integer levels in [0, 255]. A test card
lies over every image's top-left corner: ``content.CARD`` rows by columns
of RGB levels drawn uniformly from [16, 235] by a generator of the fixed
seed ``content.CARD_SEED``, the same in every image. Its blocks are the
busiest an image holds in every plane, so the largest blocks, and with
them the decode walk's output width, are the same whatever the seed.
"""

from __future__ import annotations

import torch

from codec_bench import content

# JFIF YCbCr -> RGB (ITU-T T.871 section 7), rows R, G, B over (Y, Cb - 128, Cr - 128)
YCC_TO_RGB = ((1.0, 0.0, 1.402), (1.0, -0.344136, -0.714136), (1.0, 1.772, 0.0))


def _image(gen, H: int, W: int, dev) -> torch.Tensor:
    """``[H, W, 3]`` float32 RGB, before noise and the card."""
    luma = content._texture(gen, (H, W), 20, dev)
    slope = (torch.rand(2, generator=gen, device=dev) - 0.5) * 0.6  # within +/-0.3
    own = torch.stack([content._value_noise(gen, (H, W), ((4, 1.0), (16, 0.5)), dev)
                       for _ in range(2)])
    chroma = slope[:, None, None] * (luma - 128) + 48 * (own - 0.5)
    ycc = torch.cat([luma[None], chroma])  # chroma centred on 0
    m = torch.tensor(YCC_TO_RGB, dtype=torch.float32, device=dev)
    return torch.einsum("cy,yhw->hwc", m, ycc)


def make(seed: int, cfg: dict, n_units: int, device):
    """(``[n_units, H, W, 3]`` float32 RGB images on ``device``, integer
    levels in [0, 255], a pure function of ``seed``; the images in order)."""
    dev = torch.device(device)
    H, W = cfg["H"], cfg["W"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2**63))
    images = torch.stack([_image(gen, H, W, dev) for _ in range(n_units)])
    images += 1.5 * torch.randn(images.shape, generator=gen, device=dev)
    card_gen = torch.Generator(device=dev)
    card_gen.manual_seed(content.CARD_SEED)
    ch, cw = min(content.CARD[0], H // 4), min(content.CARD[1], W // 4)
    card = torch.randint(16, 236, (ch, cw, 3), generator=card_gen, device=dev)
    images[:, :ch, :cw] = card.to(torch.float32)
    images = torch.round(images).clamp_(0, 255)
    return images, [images[i] for i in range(n_units)]
