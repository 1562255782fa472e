"""PNG files of generated images, written with ``zlib`` alone (the card
has no image library): 8-bit RGB, one unfiltered scanline a row."""

from __future__ import annotations

import os
import struct
import zlib
from typing import List

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """``rgb``: uint8 ``[H, W, 3]``."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"an RGB uint8 image, not {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def save_images(images: np.ndarray, outdir: str, prefix: str = "img"
                ) -> List[str]:
    """``images`` ``[B, H, W, 3]`` float in [0, 1] as
    ``{prefix}_{i:04d}.png`` (``(x * 255)`` truncated to uint8, as the JAX
    package's ``save_images``); returns the paths."""
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for i, img in enumerate(images):
        p = os.path.join(outdir, f"{prefix}_{i:04d}.png")
        write_png(p, (img * 255).astype(np.uint8))
        paths.append(p)
    return paths
