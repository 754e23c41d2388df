"""Seeded synthetic luma clips, made on the device in a few large calls.

A copy of the design of ``ivclab_tpu_torch/utils/fixtures.py::video``, kept
here so that a later change to the program cannot change the benchmark's
input: a larger background of multi-octave value noise with hard-edged
shapes and fine texture pans smoothly (within +/-3 px a frame, so a search
range of 4 has real motion to find), two textured objects move across it on
their own paths, and every frame gets its own sensor noise. Unlike the
fixture it draws luma alone (the codecs under test code luma), from a
``torch.Generator`` on the device seeded by ``--seed``: the same seed and
device give the same pixels.

A test card lies over every frame's top-left corner: ``CARD`` rows by
columns of levels drawn uniformly from [16, 235] by a generator of a fixed
seed (``CARD_SEED``), the same in every clip and frame. Its blocks are the
busiest a frame holds, so the largest symbol counts and block streams, which
size the fixed-codebook codec's pack, come from the card whatever the seed:
every seed's clip asks the codec for the same work shapes.
"""

from __future__ import annotations

import math

import torch

MARGIN = 64  # background border the pan moves over
CARD = (64, 480)  # the test card's rows and columns (at most a quarter of each side)
CARD_SEED = 20240601


def _value_noise(gen, shape, octaves, device) -> torch.Tensor:
    """Sum of bilinearly upsampled random grids, normalised to [0, 1]."""
    H, W = shape
    out = torch.zeros((H, W), dtype=torch.float32, device=device)
    for grid, amp in octaves:
        gh, gw = max(2, min(grid, H)), max(2, min(grid, W))
        coarse = torch.rand((1, 1, gh, gw), generator=gen, device=device)
        up = torch.nn.functional.interpolate(coarse, size=(H, W), mode="bilinear",
                                             align_corners=True)
        out += amp * up[0, 0]
    out -= out.min()
    return out / out.max().clamp_min(1e-12)


def _shapes(gen, base: torch.Tensor, n: int) -> torch.Tensor:
    """Overlay ``n`` flat-ish rectangles and ellipses (hard edges)."""
    H, W = base.shape
    dev = base.device
    # every shape's parameters in one draw: centre, radii, level, kind
    u = torch.rand((n, 6), generator=gen, device=dev, dtype=torch.float64).tolist()
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    img = base.clone()
    for cy, cx, ry, rx, level, kind in u:
        cy, cx = int(cy * H), int(cx * W)
        ry = H // 16 + int(ry * max(H // 4 - H // 16, 1))
        rx = W // 16 + int(rx * max(W // 4 - W // 16, 1))
        ry, rx = max(ry, 1), max(rx, 1)
        if kind < 0.5:
            mask = ((yy - cy).abs() < ry) & ((xx - cx).abs() < rx)
        else:
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        img = torch.where(mask, 0.35 * img + 0.65 * level, img)
    return img


def _texture(gen, shape, shapes: int, device) -> torch.Tensor:
    """A natural-looking luma field in [16, 235]."""
    luma = _value_noise(gen, shape, ((8, 1.0), (32, 0.5), (128, 0.25)), device)
    luma = _shapes(gen, luma, shapes)
    luma = luma + 0.04 * torch.randn(shape, generator=gen, device=device)
    return 16 + 219 * luma.clamp(0, 1)


def clip(seed: int, frames: int, H: int, W: int, device) -> torch.Tensor:
    """``[frames, H, W]`` float32 luma on ``device``, integer levels in
    [0, 255], a pure function of ``seed`` (any whole number >= 0)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2**63))
    bg = _texture(gen, (H + 2 * MARGIN, W + 2 * MARGIN), 20, dev)
    obj_a = _texture(gen, (48, 48), 3, dev)
    obj_b = _texture(gen, (32, 64), 3, dev)
    noise = 1.5 * torch.randn((frames, H, W), generator=gen, device=dev)
    card_gen = torch.Generator(device=dev)
    card_gen.manual_seed(CARD_SEED)
    ch, cw = min(CARD[0], H // 4), min(CARD[1], W // 4)
    card = torch.randint(16, 236, (ch, cw), generator=card_gen, device=dev).to(torch.float32)

    out = torch.empty((frames, H, W), dtype=torch.float32, device=dev)
    for t in range(frames):
        oy = min(max(MARGIN + int(round(10 * math.sin(t / 6.0))), 0), 2 * MARGIN)
        ox = min(max(MARGIN + int(round(2.2 * t)), 0), 2 * MARGIN)
        frame = bg[oy:oy + H, ox:ox + W].clone()
        ay = min(max(int(round(H * 0.3 + 3.0 * t)), 0), H - 48)
        ax = min(max(int(round(W * 0.2 + 1.5 * t)), 0), W - 48)
        frame[ay:ay + 48, ax:ax + 48] = obj_a
        by = min(max(int(round(H * 0.6 - 1.0 * t)), 0), H - 32)
        bx = min(max(int(round(W * 0.7 - 2.5 * t)), 0), W - 64)
        frame[by:by + 32, bx:bx + 64] = obj_b
        frame[:ch, :cw] = card
        out[t] = frame
    return torch.round(out + noise).clamp_(0, 255)
