"""A PNG writer and reader in numpy, ``zlib`` and ``struct``: the port's
stand-in for PIL's PNG codec, which the card's machine does not have.

``write_png`` writes 8-bit RGB ([H, W, 3] uint8), 8-bit grey ([H, W] uint8)
and 16-bit grey ([H, W] uint16, big-endian as the format stores it), one
IDAT chunk, no filtering (filter type 0 on every row).

``read_png`` reads what ``np.array(Image.open(path))`` reads for PNGs of bit
depth 8 or 16: grey, RGB, palette indices, grey + alpha and RGBA, with any
of the five row filters and any number of IDAT chunks.
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
# colour type -> samples per pixel (0 grey, 2 RGB, 3 palette index,
# 4 grey + alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


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


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filtered: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Undo the row filters: ``filtered`` [H, W, bpp] uint8 (one pixel's
    bytes per [y, x]), ``kinds`` [H] the filter type of each row.

    Each byte depends on its left, upper and upper-left neighbours, so the
    pixels are reconstructed one anti-diagonal (x + y constant) at a time,
    every row of a diagonal with its own filter."""
    if not kinds.any():
        return filtered
    if kinds.max() > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} does not exist")
    h, w, bpp = filtered.shape
    # one row and one column of zeros before the image: the neighbours a
    # pixel on the top row or the left column reads
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    src = filtered.astype(np.int32)
    for t in range(h + w - 1):
        y = np.arange(max(0, t - w + 1), min(h, t + 1))
        x = t - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        k = kinds[y][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[y + 1, x + 1] = (src[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """The pixels of the PNG file at ``path``, as ``np.array(Image.open(
    path))`` gives them for 8-bit files: [H, W] for grey and palette (the
    palette indices), [H, W, 2] grey + alpha, [H, W, 3] RGB, [H, W, 4] RGBA;
    uint8 at bit depth 8, uint16 at bit depth 16 (the full samples, as PIL
    gives them for 16-bit grey). Adam7-interlaced files and bit depths
    other than 8 and 16 raise ``NotImplementedError``."""
    data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    if interlace:
        raise NotImplementedError(f"{path}: Adam7 interlaced PNG")
    if depth not in (8, 16) or colour not in _CHANNELS or (
            colour == 3 and depth != 8):
        raise NotImplementedError(
            f"{path}: PNG bit depth {depth} with colour type {colour}")
    if compression or filter_method:
        raise ValueError(f"{path}: unknown compression or filter method")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + w * bpp):
        raise ValueError(f"{path}: image data is truncated")
    rows = raw[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    pixels = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0].copy())
    if depth == 16:
        pixels = pixels.reshape(h, w, channels, 2).view(">u2")[..., 0]
        pixels = pixels.astype(np.uint16)
    pixels = pixels.reshape(h, w, channels)
    return pixels[..., 0] if channels == 1 else pixels
