"""A PNG writer and reader in numpy, ``zlib`` and ``struct``: the port's
stand-in for PIL's PNG codec, which the card's machine does not have.

``write_png`` writes 8-bit RGB ([H, W, 3] uint8), 8-bit grey ([H, W] uint8)
and 16-bit grey ([H, W] uint16, big-endian as the format stores it), one
IDAT chunk, no filtering (filter type 0 on every row).

``decode_png`` (and ``read_png`` of a file) reads what
``np.array(Image.open(f))`` reads: grey at every bit depth, RGB, palette
indices, grey + alpha and RGBA, interlaced (Adam7) or not, with any of the
five row filters and any number of IDAT chunks; ``png_palette`` gives the
colours of a palette image's indices.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional

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


# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# the bit depths each colour type allows
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def _reduced_image(raw: np.ndarray, h: int, w: int, depth: int,
                   channels: int):
    """Unfilter one (sub-)image of ``h`` rows of ``w`` pixels from the start
    of ``raw``; returns (samples [h, w, channels] uint8 or uint16, bytes
    used). Bit depths below 8 (one channel) are unpacked MSB first."""
    if h == 0 or w == 0:
        return np.zeros((h, w, channels), np.uint16 if depth == 16
                        else np.uint8), 0
    if depth < 8:
        stride, bpp = -(-w * depth // 8), 1
    else:
        bpp = channels * depth // 8
        stride = w * bpp
    used = h * (1 + stride)
    if raw.size < used:
        raise ValueError("PNG image data is truncated")
    rows = raw[:used].reshape(h, 1 + stride)
    filtered = rows[:, 1:].reshape(h, stride // bpp, bpp)
    data = _unfilter(filtered, rows[:, 0].copy()).reshape(h, stride)
    if depth < 8:
        bits = np.unpackbits(data, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        samples = (bits[:, :w] * weights).sum(-1).astype(np.uint8)
        return samples[..., None], used
    if depth == 16:
        samples = data.reshape(h, w, channels, 2).view(">u2")[..., 0]
        return samples.astype(np.uint16), used
    return data.reshape(h, w, channels), used


def _chunks(data: bytes):
    """(IHDR fields, the joined IDAT bodies, the PLTE body or None) of a
    PNG byte string."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat, palette = 8, None, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG: no IHDR or no IDAT chunk")
    return header, b"".join(idat), palette


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a PNG byte string, as ``np.array(Image.open(f))`` gives
    them: [H, W] for grey and palette (the palette indices), [H, W, 2] grey
    + alpha, [H, W, 3] RGB, [H, W, 4] RGBA; uint8 at bit depth 8, uint16 for
    16-bit grey (PIL's ``I;16``), the high bytes of 16-bit colour as uint8
    (PIL's ``RGB`` and ``RGBA``; 16-bit grey + alpha widened to RGBA), bool
    for 1-bit grey (PIL's mode ``1``), 2- and 4-bit grey scaled to 8 bits
    (x85, x17), and 1-, 2- and 4-bit palette indices unscaled. Interlaced
    (Adam7) or not, any row filters, any number of IDAT chunks."""
    header, idat, _ = _chunks(data)
    w, h, depth, colour, compression, filter_method, interlace = header
    if colour not in _DEPTHS or depth not in _DEPTHS[colour]:
        raise ValueError(f"PNG: bit depth {depth} with colour type {colour} "
                         "does not exist")
    if compression or filter_method or interlace > 1:
        raise ValueError("PNG: unknown compression, filter or interlace "
                         "method")
    channels = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if interlace:
        pixels = np.zeros((h, w, channels),
                          np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            ph, pw = -(-max(h - y0, 0) // dy), -(-max(w - x0, 0) // dx)
            sub, used = _reduced_image(raw[at:], ph, pw, depth, channels)
            pixels[y0::dy, x0::dx] = sub
            at += used
    else:
        pixels, _ = _reduced_image(raw, h, w, depth, channels)
    if depth < 8 and colour == 0:
        # PIL's modes 1, L;2 and L;4
        pixels = (pixels > 0) if depth == 1 else (
            pixels * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if depth == 16 and colour != 0:
        pixels = (pixels >> 8).astype(np.uint8)
        if colour == 4:
            pixels = pixels[..., [0, 0, 0, 1]]
    return pixels[..., 0] if pixels.shape[-1] == 1 else pixels


def png_palette(data: bytes) -> Optional[np.ndarray]:
    """The [N, 3] uint8 palette of a palette PNG byte string (the colours
    ``decode_png``'s indices name, PIL's mode ``P``); None for any other
    colour type."""
    header, _, palette = _chunks(data)
    if header[3] != 3:
        return None
    if palette is None or len(palette) % 3:
        raise ValueError("PNG: palette image without a valid PLTE chunk")
    return np.frombuffer(palette, np.uint8).reshape(-1, 3).copy()


def read_png(path) -> np.ndarray:
    """``decode_png`` of the file at ``path`` (errors name the file)."""
    try:
        return decode_png(Path(path).read_bytes())
    except ValueError as err:
        raise ValueError(f"{path}: {err}") from None
