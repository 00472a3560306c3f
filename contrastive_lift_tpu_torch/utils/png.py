"""A PNG writer in numpy, ``zlib`` and ``struct``: the port's stand-in for
PIL's encoder, which the card's machine does not have.

``write_png`` writes 8-bit RGB ([H, W, 3] uint8), 8-bit grey ([H, W] uint8)
and 16-bit grey ([H, W] uint16, big-endian as the format stores it), one
IDAT chunk, no filtering (filter type 0 on every row).
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (dtype, channels) -> (bit depth, colour type)
_FORMATS = {(np.dtype(np.uint8), 3): (8, 2), (np.dtype(np.uint8), 1): (8, 0),
            (np.dtype(np.uint16), 1): (16, 0)}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray) -> Path:
    """``image`` as a PNG file at ``path``: [H, W, 3] uint8 (RGB), [H, W]
    uint8 or [H, W] uint16 (grey)."""
    image = np.asarray(image)
    channels = image.shape[2] if image.ndim == 3 else 1
    key = (image.dtype, channels)
    if key not in _FORMATS or image.ndim not in (2, 3):
        raise ValueError(f"write_png takes [H, W, 3] uint8, [H, W] uint8 or "
                         f"[H, W] uint16, got {image.shape} {image.dtype}")
    depth, colour = _FORMATS[key]
    h, w = image.shape[:2]
    rows = np.ascontiguousarray(image.astype(image.dtype.newbyteorder(">")))
    raw = rows.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), raw], axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    path = Path(path)
    path.write_bytes(_SIGNATURE + _chunk(b"IHDR", header)
                     + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
                     + _chunk(b"IEND", b""))
    return path
