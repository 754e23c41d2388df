"""Image file I/O and display.

Port of ``ivclab_tpu/utils/io.py`` (the course reference's imread/imshow,
plus imwrite and write_video). PIL, matplotlib, cv2 and imageio are
optional: each is imported only inside the function that uses it, so the
package imports, and every codec runs, without them. Tensors are taken to
the host first.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def imread(filepath: str) -> np.ndarray:
    from PIL import Image

    with Image.open(filepath) as data:
        return np.asarray(data)


def imwrite(filepath: str, img) -> None:
    from PIL import Image

    arr = _host(img)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(filepath)


def write_video(filepath: str, frames, fps: int = 10) -> str:
    """Export RGB frames ``[T, H, W, 3]`` to a video file.

    Backends are tried in order (cv2, imageio); where neither is installed
    the frames are written losslessly as numbered PNGs into a directory
    named after the target's stem, and that directory is returned.
    """
    frames = _host(frames)
    if frames.dtype != np.uint8:
        frames = np.clip(np.round(frames), 0, 255).astype(np.uint8)
    try:
        import cv2

        H, W = frames.shape[1:3]
        out = cv2.VideoWriter(filepath, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
        if out.isOpened():  # a codec/container mismatch otherwise writes nothing, silently
            for frame in frames:
                out.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            out.release()
            return filepath
        out.release()
    except ImportError:
        pass
    try:
        import imageio

        imageio.mimwrite(filepath, list(frames), fps=fps)
        return filepath
    except ImportError:
        pass
    outdir = Path(filepath).with_suffix("")
    outdir.mkdir(parents=True, exist_ok=True)
    for t, frame in enumerate(frames):
        imwrite(str(outdir / f"frame{t:04d}.png"), frame)
    return str(outdir)


def imshow(ax, img, title=None, hide_ticks: bool = True):
    arr = _host(img)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        ax.imshow(arr[..., 0], cmap="gray")
    elif arr.ndim == 2:
        ax.imshow(arr, cmap="gray")
    else:
        ax.imshow(arr)
    if title is not None:
        ax.set_title(title)
    if hide_ticks:
        ax.set_xticks([])
        ax.set_yticks([])
    return ax
