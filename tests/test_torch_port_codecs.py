"""The port's image codecs and resizes against PIL and ``jax.image``.

``utils/png.py::read_png`` and ``utils/jpeg.py::read_jpeg`` stand in for
``np.array(Image.open(path))``, ``utils/jpeg.py::encode_jpeg`` for PIL's
``save(f, "JPEG", quality=q)``, and ``utils/image.py`` for PIL's NEAREST
and LANCZOS resizes, its ``convert("L")`` and ``jax.image.resize(method=
"bilinear")``, on a machine without PIL or JAX. Bars:

- PNG reading (any filter, Adam7, bit depths 1 to 16) and NEAREST
  resizing: ``array_equal`` with PIL;
- JPEG encoding: the bytes PIL writes;
- baseline JPEG decoding: within 1 level of PIL everywhere and equal on at
  least 99.9% of the values (the decoder follows libjpeg-turbo's integer
  IDCT, upsampling and colour tables, so in practice it is equal); every
  other JPEG: ``array_equal`` with PIL (progressive files and their block
  smoothing, RGB-coded, CMYK and YCCK files, any integral chroma
  sampling, arithmetic-coded and lossless files); the files PIL refuses,
  refused;
- LANCZOS and the grey conversion: ``array_equal`` with PIL (the same
  fixed-point coefficients);
- bilinear: within 1e-6 of ``jax.image.resize`` (float32 sums in another
  order).

The hand-written writers below make the files PIL reads but does not write
(other chroma samplings, arithmetic coding, lossless); PIL reading them as
the source image is what checks the writers, and so the arithmetic state
table the writer and the decoder share.

Run as a script, the file prints the seconds the host takes to encode and
to decode a 968x1296 4:2:0 frame (``python tests/test_torch_port_codecs.py``).
"""
import io
import re
import struct
import sys
import time
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image, ImageFile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from contrastive_lift_tpu_torch.utils.image import (  # noqa: E402
    cmyk_to_rgb, image_mode, image_palette, image_size, read_image,
    resize_bilinear_chw, resize_lanczos_uint8, resize_nearest, resize_pil,
    to_grey_pil)
from contrastive_lift_tpu_torch.utils.jpeg import (  # noqa: E402
    ARITH_TABLE, NATURAL_ORDER, decode_jpeg, encode_jpeg, fdct_islow,
    jpeg_mode, jpeg_size, quant_tables, quantize, read_jpeg, rgb_to_ycc,
    write_jpeg)
from contrastive_lift_tpu_torch.utils.png import (  # noqa: E402
    decode_png, read_png, write_png)

jax.config.update("jax_platforms", "cpu")

# size of the frame the scene readers decode (ScanNet colour, 968x1296)
FRAME_HW = (968, 1296)


def _image(h, w, channels, seed=0, noise=20.0):
    """A smooth colour pattern with noise: what a photo gives a codec."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, (xx * yy) % 256],
                    -1).astype(np.float64)
    base += rng.normal(0, noise, base.shape)
    arr = np.clip(base, 0, 255).astype(np.uint8)
    return arr[..., 0] if channels == 1 else arr[..., :channels].copy()


# ---------------------------------------------------------------------------
# Hand-written JPEG writers: files PIL reads but does not write (chroma
# sampling other than 4:4:4, 4:2:2 and 4:2:0, arithmetic coding, lossless)
# ---------------------------------------------------------------------------

def _seg(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


JFIF_APP0 = _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe_app14(transform: int) -> bytes:
    return _seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


# Huffman tables as (code counts by length 1-16, symbols): flat ones for
# the DC categories 0-11 and the 162 AC run/size symbols, and one for the
# lossless categories 0-16 with short codes for the small ones
_DC_TABLE = ([0, 0, 0, 12] + [0] * 12, list(range(12)))
_AC_TABLE = ([0] * 7 + [162] + [0] * 8,
             [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                             for s in range(1, 11)])
_LOSSLESS_TABLE = ([0, 2, 2, 1, 1, 1, 1, 1, 8] + [0] * 7,
                   [1, 2, 0, 3, 4, 5, 6, 7, 8] + list(range(9, 17)))


def _dht(cls: int, table: int, spec) -> bytes:
    counts, symbols = spec
    return _seg(0xC4, bytes([(cls << 4) | table] + counts) + bytes(symbols))


def _codes(spec):
    """The canonical codes of a table: {symbol: (code, length)}."""
    counts, symbols = spec
    out, code, k = {}, 0, 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _Bits:
    """A Huffman bit stream: bits appended MSB first, flushed padded with
    1-bits and byte-stuffed (jchuff.c)."""

    def __init__(self):
        self.parts = []

    def put(self, value: int, n: int) -> None:
        if n:
            self.parts.append(format(value & ((1 << n) - 1), f"0{n}b"))

    def value(self, v: int) -> None:
        """Category code already written: the value's extra bits."""
        s = abs(v).bit_length()
        self.put(v if v >= 0 else v + (1 << s) - 1, s)

    def flush(self) -> bytes:
        bits = "".join(self.parts)
        bits += "1" * (-len(bits) % 8)
        self.parts = []
        raw = int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""
        return raw.replace(b"\xff", b"\xff\x00")


def _frame(marker, height, width, ids, factors, tables):
    return _seg(marker, struct.pack(">BHHB", 8, height, width, len(ids))
                + b"".join(bytes([i, (h << 4) | v, t]) for i, (h, v), t
                           in zip(ids, factors, tables)))


def _geometry(height, width, factors, unit=8):
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    return hmax, vmax, -(-width // (unit * hmax)), -(-height // (unit * vmax))


def _coefficients(planes, factors, quant):
    """Quantised DCT coefficients [rows, cols, 64] (natural order) of each
    component over the whole MCU grid. A component sampled h x v of hmax x
    vmax takes the pixel at (y * vmax // v, x * hmax // h) of its plane
    (edge-padded), so any factors work, integral or not."""
    height, width = planes[0].shape
    hmax, vmax, mcux, mcuy = _geometry(height, width, factors)
    out = []
    for plane, (h, v), q in zip(planes, factors, quant):
        rows, cols = mcuy * v * 8, mcux * h * 8
        ys = np.minimum(np.arange(rows) * vmax // v, height - 1)
        xs = np.minimum(np.arange(cols) * hmax // h, width - 1)
        p = plane.astype(np.int64)[ys][:, xs] - 128
        blocks = p.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3)
        coefs = quantize(fdct_islow(blocks.reshape(-1, 8, 8)).reshape(-1, 64),
                         q)
        out.append(coefs.reshape(rows // 8, cols // 8, 64))
    return out


def _mcus(scan, factors, height, width):
    """The blocks of a scan's MCUs in coding order: lists of (component,
    block row, block column); the MCU grid for an interleaved scan, the
    component's own blocks for a one-component scan."""
    hmax, vmax, mcux, mcuy = _geometry(height, width, factors)
    if len(scan) == 1:
        (c,) = scan
        h, v = factors[c]
        bh = -(-(-(-height * v // vmax)) // 8)
        bw = -(-(-(-width * h // hmax)) // 8)
        return [[(c, y, x)] for y in range(bh) for x in range(bw)]
    return [[(c, my * factors[c][1] + y, mx * factors[c][0] + x)
             for c in scan for y in range(factors[c][1])
             for x in range(factors[c][0])]
            for my in range(mcuy) for mx in range(mcux)]


def _restarted(mcus, restart):
    """The MCUs in restart intervals of ``restart`` MCUs (one interval if
    0)."""
    if not restart:
        return [mcus]
    return [mcus[i:i + restart] for i in range(0, len(mcus), restart)]


def _entropy(intervals, encode_interval) -> bytes:
    """The entropy-coded data of a scan: each interval's bytes, RSTn
    markers between them."""
    out = []
    for n, interval in enumerate(intervals):
        if n:
            out.append(bytes([0xFF, 0xD0 + (n - 1) % 8]))
        out.append(encode_interval(interval))
    return b"".join(out)


def _quant_segments(quant):
    return b"".join(_seg(0xDB, bytes([t]) + bytes(q[NATURAL_ORDER].astype(
        np.uint8))) for t, q in enumerate(quant))


def write_huffman_jpeg(planes, factors, ids=None, markers=b"", quality=90,
                       restart=0) -> bytes:
    """A baseline sequential file of ``planes`` (uint8 [H, W] each, already
    in the coded colour space) with any sampling ``factors`` [(h, v)], one
    interleaved scan, flat Huffman tables; ``markers`` go after SOI."""
    height, width = planes[0].shape
    ids = ids or list(range(1, len(planes) + 1))
    luma, chroma = quant_tables(quality)
    quant = [luma, chroma][:min(len(planes), 2)]
    tq = [min(c, 1) for c in range(len(planes))]
    coefs = _coefficients(planes, factors, [quant[t] for t in tq])
    scan = list(range(len(planes)))
    dc_code, ac_code = _codes(_DC_TABLE), _codes(_AC_TABLE)

    def encode(interval):
        bits, preds = _Bits(), [0] * len(planes)
        for mcu in interval:
            for c, y, x in mcu:
                block = coefs[c][y, x][NATURAL_ORDER]
                diff = int(block[0]) - preds[c]
                preds[c] = int(block[0])
                bits.put(*dc_code[abs(diff).bit_length()])
                bits.value(diff)
                run = 0
                last = max([k for k in range(1, 64) if block[k]], default=0)
                for k in range(1, last + 1):
                    if block[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*ac_code[0xF0])
                        run -= 16
                    v = int(block[k])
                    bits.put(*ac_code[(run << 4) | abs(v).bit_length()])
                    bits.value(v)
                    run = 0
                if last < 63:
                    bits.put(*ac_code[0x00])
        return bits.flush()

    data = _entropy(_restarted(_mcus(scan, factors, height, width), restart),
                    encode)
    return (b"\xff\xd8" + markers + _quant_segments(quant)
            + _frame(0xC0, height, width, ids, factors, tq)
            + _dht(0, 0, _DC_TABLE) + _dht(1, 0, _AC_TABLE)
            + (_seg(0xDD, struct.pack(">H", restart)) if restart else b"")
            + _seg(0xDA, bytes([len(ids)]) + b"".join(
                bytes([i, 0]) for i in ids) + b"\x00\x3f\x00")
            + data + b"\xff\xd9")


class _ArithEncoder:
    """ITU-T T.81 Annex D's arithmetic encoder (the jcarith.c counterpart
    of the port's decoder): Code_LPS / Code_MPS with the conditional
    exchange, Renorm_e, carries propagated into the bytes already out,
    the final bits flushed as in Figure D.12; ``data()`` byte-stuffs."""

    def __init__(self):
        self.c, self.a, self.ct = 0, 0x10000, 11
        self.out = bytearray()

    def __call__(self, st, i, bit) -> None:
        sv = st[i]
        q = ARITH_TABLE[sv & 0x7F]
        qe = q >> 16
        self.a -= qe
        if bit != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (q & 0xFF)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ ((q >> 8) & 0xFF)
        while self.a < 0x8000:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out()
                self.ct = 8

    def _byte_out(self) -> None:
        t = self.c >> 19
        if t > 0xFF:
            i = len(self.out) - 1
            while self.out[i] == 0xFF:
                self.out[i] = 0
                i -= 1
            self.out[i] += 1
        self.out.append(t & 0xFF)
        self.c &= 0x7FFFF

    def data(self) -> bytes:
        t = (self.c + self.a - 1) & 0xFFFF0000
        self.c = t + 0x8000 if t < self.c else t
        self.c <<= self.ct
        self._byte_out()
        self.c <<= 8
        self._byte_out()
        return bytes(self.out).replace(b"\xff", b"\xff\x00")


def _arith_magnitude(enc, st, s, x2, v) -> None:
    """Figures F.8-F.9 mirrored: ``v`` = |value| - 1, its category's first
    decision at bin ``s`` (taken twice for AC, whose X1 is that bin), the
    rest from bin ``x2``."""
    if v == 0:
        enc(st, s, 0)
        return 0
    enc(st, s, 1)
    m = 1
    if x2 is None:                 # DC: X1 = 20
        s = 20
    elif v == 1:
        enc(st, s, 0)
        return 1
    else:
        enc(st, s, 1)
        m, s = 2, x2
    while v >= 2 * m:
        enc(st, s, 1)
        m <<= 1
        s += 1
    enc(st, s, 0)
    s += 14
    b = m >> 1
    while b:
        enc(st, s, int(bool(v & b)))
        b >>= 1
    return m


def write_arithmetic_jpeg(planes, factors, ids=None, markers=b"",
                          quality=90, restart=0, progressive=False,
                          dac=None) -> bytes:
    """A sequential (SOF9, one interleaved scan) or progressive (SOF10,
    libjpeg's ``jpeg_simple_progression`` script) arithmetic-coded file;
    ``dac`` ({"dc": (L, U), "ac": K} for conditioning table 0) adds a DAC
    segment. Arguments as ``write_huffman_jpeg``'s."""
    height, width = planes[0].shape
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    luma, chroma = quant_tables(quality)
    quant = [luma, chroma][:min(n, 2)]
    tq = [min(c, 1) for c in range(n)]
    coefs = _coefficients(planes, factors, [quant[t] for t in tq])
    lo, hi = (dac or {}).get("dc", (0, 1))
    kx = (dac or {}).get("ac", 5)
    every = list(range(n))
    if not progressive:
        script = [(every, 0, 63, 0, 0)]
    elif n == 3:
        script = [(every, 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1),
                  ([1], 1, 63, 0, 1), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
                  (every, 0, 0, 1, 0), ([2], 1, 63, 1, 0), ([1], 1, 63, 1, 0),
                  ([0], 1, 63, 1, 0)]
    else:
        script = ([(every, 0, 0, 0, 1)]
                  + [([c], 1, 5, 0, 2) for c in every]
                  + [([c], 6, 63, 0, 2) for c in every]
                  + [([c], 1, 63, 2, 1) for c in every]
                  + [(every, 0, 0, 1, 0)]
                  + [([c], 1, 63, 1, 0) for c in every])

    def scan_data(scan, ss, se, ah, al):
        def encode(interval):
            enc = _ArithEncoder()
            dc_st, ac_st = bytearray(64), bytearray(256)
            fixed = bytearray([113])
            preds, ctx = [0] * n, [0] * n
            for mcu in interval:
                for c, y, x in mcu:
                    block = [int(v) for v in coefs[c][y, x][NATURAL_ORDER]]
                    if ss == 0 and ah == 0:
                        dc = block[0] >> al
                        diff, preds[c] = dc - preds[c], dc
                        base = ctx[c]
                        if diff == 0:
                            enc(dc_st, base, 0)
                            ctx[c] = 0
                        else:
                            enc(dc_st, base, 1)
                            sign = int(diff < 0)
                            enc(dc_st, base + 1, sign)
                            m = _arith_magnitude(enc, dc_st, base + 2 + sign,
                                                 None, abs(diff) - 1)
                            ctx[c] = (0 if m < (1 << lo) >> 1 else
                                      12 + 4 * sign if m > (1 << hi) >> 1
                                      else 4 + 4 * sign)
                    elif ss == 0:
                        enc(fixed, 0, (block[0] >> al) & 1)
                    if se == 0:
                        continue
                    first = 1 if ss == 0 else ss
                    # the values this scan sends, and (refine) what the
                    # decoder already holds
                    cur = [0] + [(abs(v) >> al) * (1 if v >= 0 else -1)
                                 for v in block[1:]]
                    end = max([k for k in range(first, se + 1) if cur[k]],
                              default=0)
                    if ah:
                        held = max([k for k in range(1, se + 1)
                                    if abs(block[k]) >> (al + 1)], default=0)
                        k = first
                        while k <= se:
                            s = 3 * (k - 1)
                            if k > held:
                                enc(ac_st, s, int(k > end))
                                if k > end:
                                    break
                            while True:
                                if abs(block[k]) >> (al + 1):
                                    enc(ac_st, s + 2, abs(cur[k]) & 1)
                                    break
                                if cur[k]:
                                    enc(ac_st, s + 1, 1)
                                    enc(fixed, 0, int(cur[k] < 0))
                                    break
                                enc(ac_st, s + 1, 0)
                                s += 3
                                k += 1
                            k += 1
                        continue
                    k = first
                    while k <= se:
                        s = 3 * (k - 1)
                        if k > end:
                            enc(ac_st, s, 1)
                            break
                        enc(ac_st, s, 0)
                        while not cur[k]:
                            enc(ac_st, s + 1, 0)
                            s += 3
                            k += 1
                        enc(ac_st, s + 1, 1)
                        enc(fixed, 0, int(cur[k] < 0))
                        _arith_magnitude(enc, ac_st, s + 2,
                                         189 if k <= kx else 217,
                                         abs(cur[k]) - 1)
                        k += 1
            return enc.data()

        mcus = _mcus(scan, factors, height, width)
        return (_seg(0xDA, bytes([len(scan)]) + b"".join(
            bytes([ids[c], 0]) for c in scan) + bytes([ss, se, (ah << 4) | al]))
            + _entropy(_restarted(mcus, restart), encode))

    dac_seg = b""
    if dac:
        dac_seg = _seg(0xCC, bytes([0, (hi << 4) | lo, 16, kx]))
    return (b"\xff\xd8" + markers + _quant_segments(quant)
            + _frame(0xCA if progressive else 0xC9, height, width, ids,
                     factors, tq) + dac_seg
            + (_seg(0xDD, struct.pack(">H", restart)) if restart else b"")
            + b"".join(scan_data(*s) for s in script) + b"\xff\xd9")


def _predict(x, psv, initial, first_rows):
    """The lossless predictions of samples ``x`` [h, w] (jcdiffct.c's
    counterpart of the decoder's undifferencing)."""
    x = x.astype(np.int64)
    pred = np.empty_like(x)
    for r in range(len(x)):
        if r in first_rows:
            pred[r, 0] = initial
            pred[r, 1:] = x[r, :-1]
            continue
        ra, rb = x[r, :-1], x[r - 1, 1:]
        rc = x[r - 1, :-1]
        pred[r, 0] = x[r - 1, 0]
        pred[r, 1:] = [ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                       rb + ((ra - rc) >> 1), (ra + rb) >> 1][psv - 1]
    return pred


def write_lossless_jpeg(planes, psv, pt=0, ids=None, markers=b"",
                        restart_rows=0, interleaved=True) -> bytes:
    """A lossless (SOF3) file of full-size ``planes``: predictor ``psv``,
    point transform ``pt``, restart intervals of ``restart_rows`` rows, one
    interleaved scan or one scan a component."""
    height, width = planes[0].shape
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    first = {0} | set(range(restart_rows, height, restart_rows or height))
    diffs = []
    for plane in planes:
        x = plane.astype(np.int64) >> pt
        d = (x - _predict(x, psv, 1 << (8 - pt - 1), first)) & 0xFFFF
        diffs.append(np.where(d >= 0x8000, d - 0x10000, d))

    codes = _codes(_LOSSLESS_TABLE)

    def encode(rows):
        bits = _Bits()
        for row in rows:
            for d in row:
                s = 16 if d == -32768 else abs(int(d)).bit_length()
                bits.put(*codes[s])
                if s < 16:
                    bits.value(int(d))
        return bits.flush()

    scans = [list(range(n))] if interleaved else [[c] for c in
 range(n)]
    body = b""
    for scan in scans:
        rows = [np.stack([diffs[c][r] for c in scan], -1).reshape(-1)
                for r in range(height)]
        intervals = ([rows[i:i + restart_rows] for i in range(
            0, height, restart_rows)] if restart_rows else [rows])
        body += (_seg(0xDA, bytes([len(scan)]) + b"".join(
            bytes([ids[c], 0]) for c in scan) + bytes([psv, 0, pt]))
            + _entropy(intervals, encode))
    return (b"\xff\xd8" + markers
            + _frame(0xC3, height, width, ids, [(1, 1)] * n, [0] * n)
            + _dht(0, 0, _LOSSLESS_TABLE)
            + (_seg(0xDD, struct.pack(">H", restart_rows * width))
               if restart_rows else b"")
            + body + b"\xff\xd9")


def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_with_filters(path, pixels, colour, depth, filters, idat_parts=1):
    """A PNG whose row r uses filter ``filters[r % len(filters)]``, the
    image data split over ``idat_parts`` IDAT chunks."""
    h, w = pixels.shape[:2]
    raw = np.ascontiguousarray(pixels.astype(pixels.dtype.newbyteorder(">")))
    raw = raw.reshape(h, -1).view(np.uint8).astype(np.int64)
    bpp = raw.shape[1] // w
    rows = []
    for r in range(h):
        kind = filters[r % len(filters)]
        x = raw[r]
        up = raw[r - 1] if r else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8)
                    .tobytes())
    body = zlib.compress(b"".join(rows))
    cut = [len(body) * i // idat_parts for i in range(idat_parts + 1)]
    chunks = b"".join(_png_chunk(b"IDAT", body[a:b])
                      for a, b in zip(cut[:-1], cut[1:]))
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                           + chunks + _png_chunk(b"IEND", b""))
    return path


PIL_MODES = {
    "L": lambda: _image(37, 53, 1),
    "LA": lambda: _image(23, 31, 2),
    "RGB": lambda: _image(41, 29, 3),
    "RGBA": lambda: np.concatenate([_image(23, 31, 3), _image(23, 31, 1, 7)
                                    [..., None]], -1),
    "I;16": lambda: (np.random.default_rng(3).integers(
        0, 65536, (19, 27)).astype(np.uint16)),
    "I;16 smooth": lambda: (np.add.outer(np.arange(30), np.arange(40))
                            * 300).astype(np.uint16),
}


@pytest.mark.parametrize("mode", sorted(PIL_MODES))
def test_read_png_matches_pil(tmp_path, mode):
    """PNGs PIL writes (its encoder picks a filter per row): equal."""
    arr = PIL_MODES[mode]()
    path = tmp_path / "x.png"
    Image.fromarray(arr).save(path)
    assert Image.open(path).mode == mode.split()[0]
    got = read_png(path)
    want = np.array(Image.open(path))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_read_png_palette_gives_indices(tmp_path):
    im = Image.fromarray(_image(30, 40, 3)).quantize(50)
    im.save(tmp_path / "p.png")
    np.testing.assert_array_equal(read_png(tmp_path / "p.png"),
                                  np.array(Image.open(tmp_path / "p.png")))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("colour,depth", [(0, 8), (2, 8), (6, 8), (4, 8),
                                          (0, 16), (2, 16)])
def test_read_png_every_filter(tmp_path, filters, colour, depth):
    """Every row filter, at bit depths 8 and 16, with the image data in
    three IDAT chunks, against PIL. PIL gives 16-bit colour as its high
    bytes (mode RGB), and 16-bit grey whole (I;16)."""
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    dtype = np.uint16 if depth == 16 else np.uint8
    rng = np.random.default_rng(colour * 10 + depth)
    pixels = rng.integers(0, np.iinfo(dtype).max + 1, (11, 13, channels))
    pixels = pixels.astype(dtype)
    if channels == 1:
        pixels = pixels[..., 0]
    path = _png_with_filters(tmp_path / "f.png", pixels, colour, depth,
                             filters, idat_parts=3)
    got = read_png(path)
    np.testing.assert_array_equal(got, (pixels >> 8).astype(np.uint8)
                                  if depth == 16 and channels > 1 else pixels)
    np.testing.assert_array_equal(got, np.array(Image.open(path)))


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (9, 14)),
                                         (np.uint8, (9, 14, 3)),
                                         (np.uint16, (9, 14))])
def test_write_read_round_trip(tmp_path, dtype, shape):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = write_png(tmp_path / "r.png", arr)
    got = read_png(path)
    assert got.dtype == arr.dtype
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(np.array(Image.open(path)), arr)


# Adam7: (first column, first row, column step, row step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
PNG_FORMS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def _pack_samples(samples, depth):
    """[h, w, c] samples -> [h, bytes per row] uint8, big-endian, bit depths
    below 8 packed MSB first with each row padded to a byte."""
    h = samples.shape[0]
    if depth >= 8:
        dtype = np.dtype(">u2") if depth == 16 else np.uint8
        return np.ascontiguousarray(samples.astype(dtype)).reshape(h, -1).view(
            np.uint8)
    bits = (samples[..., 0][..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filtered(raw, bpp, filters):
    """Filter the rows of ``raw`` [h, n] uint8, row r with filter
    ``filters[r % len(filters)]``."""
    raw = raw.astype(np.int64)
    rows = []
    for r in range(len(raw)):
        kind = filters[r % len(filters)]
        x = raw[r]
        up = raw[r - 1] if r else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        pred = [0, left, up, (left + up) >> 1, None][kind]
        if kind == 4:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8)
                    .tobytes())
    return b"".join(rows)


def _png_form(samples, colour, depth, interlace, filters=(0, 1, 2, 3, 4)):
    """A PNG of ``samples`` [h, w, c] at any colour type and bit depth,
    Adam7-interlaced or not (each pass filtered on its own), with a
    palette of distinct colours for colour type 3."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        body = b"".join(_filtered(_pack_samples(sub, depth), bpp, filters)
                        for sub in (samples[y0::dy, x0::dx]
                                    for x0, y0, dx, dy in ADAM7) if sub.size)
    else:
        body = _filtered(_pack_samples(samples, depth), bpp, filters)
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace))
    palette = (_png_chunk(b"PLTE", (np.arange(3 << depth) * 7 % 256).astype(
        np.uint8).tobytes()) if colour == 3 else b"")
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header) + palette
            + _png_chunk(b"IDAT", zlib.compress(body))
            + _png_chunk(b"IEND", b""))


@pytest.mark.parametrize("hw", [(1, 1), (3, 2), (9, 13), (17, 8)])
@pytest.mark.parametrize("colour,depth", PNG_FORMS)
def test_read_png_adam7_matches_pil(hw, colour, depth):
    """Adam7-interlaced PNGs (passes empty at the smallest sizes) of every
    colour type at every bit depth it allows, against ``np.array(
    Image.open)``: 1-bit grey as bool, 2- and 4-bit grey scaled, palette
    indices unscaled, 16-bit colour as PIL's high bytes, 16-bit grey +
    alpha widened to RGBA as PIL does."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    rng = np.random.default_rng(colour * 100 + depth)
    samples = rng.integers(0, 1 << depth, hw + (channels,))
    data = _png_form(samples, colour, depth, interlace=True)
    want = np.array(Image.open(io.BytesIO(data)))
    got = decode_png(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("colour,depth", [(0, 1), (0, 2), (0, 4), (3, 1),
                                          (3, 2), (3, 4)])
@pytest.mark.parametrize("interlace", [False, True])
def test_read_png_low_bit_depths(tmp_path, colour, depth, interlace):
    """Bit depths 1, 2 and 4 on rows that end mid-byte, through
    ``read_png``: grey as PIL's modes 1 (bool), L;2 (x85) and L;4 (x17),
    palette as indices."""
    rng = np.random.default_rng(depth)
    samples = rng.integers(0, 1 << depth, (11, 13, 1))
    path = tmp_path / "low.png"
    path.write_bytes(_png_form(samples, colour, depth, interlace))
    want = np.array(Image.open(path))
    got = read_png(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    expected = (samples[..., 0] > 0 if depth == 1 else samples[..., 0] * (
        255 // ((1 << depth) - 1))) if colour == 0 else samples[..., 0]
    np.testing.assert_array_equal(got, expected)


def test_read_png_pil_writes_low_bit_palette(tmp_path):
    """What PIL itself writes at 1, 2 and 4 bits (mode 1, and P with
    ``bits``): equal."""
    rng = np.random.default_rng(9)
    Image.fromarray(rng.random((19, 21)) > 0.5).save(tmp_path / "b.png")
    im = Image.fromarray(_image(19, 21, 3)).quantize(4)
    im.save(tmp_path / "p2.png", bits=2)
    Image.fromarray(_image(19, 21, 3)).quantize(16).save(tmp_path / "p4.png",
                                                           bits=4)
    for name in ("b.png", "p2.png", "p4.png"):
        want = np.array(Image.open(tmp_path / name))
        got = read_png(tmp_path / name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _jpeg_bytes(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _assert_jpeg_close(data):
    got = decode_jpeg(data)
    want = np.array(Image.open(io.BytesIO(data)))
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", ["grey", "4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("hw", [(16, 16), (17, 23), (33, 47), (5, 3),
                                (2, 9), (1, 1)])
def test_jpeg_matches_pil(hw, sampling, quality):
    """Sizes on and off the MCU grid, the chroma samplings PIL writes and
    three qualities."""
    if sampling == "grey":
        data = _jpeg_bytes(_image(*hw, 1), quality=quality)
    else:
        data = _jpeg_bytes(_image(*hw, 3), quality=quality,
                           subsampling=sampling)
    _assert_jpeg_close(data)


@pytest.mark.parametrize("restart", [dict(restart_marker_blocks=3),
                                     dict(restart_marker_rows=1)])
@pytest.mark.parametrize("sampling", ["grey", "4:2:0"])
def test_jpeg_restart_intervals(restart, sampling):
    arr = _image(50, 77, 1 if sampling == "grey" else 3)
    kw = {} if sampling == "grey" else {"subsampling": sampling}
    try:
        data = _jpeg_bytes(arr, quality=90, **restart, **kw)
    except TypeError:
        pytest.skip(f"this Pillow cannot write {restart}")
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _assert_jpeg_close(data)


def test_jpeg_scene_writer_masks(tmp_path):
    """The grey invalid masks SceneWriter writes (PIL, default quality):
    thresholded at > 0 as the reader does, equal."""
    rng = np.random.default_rng(5)
    mask = (rng.random((24, 32)) > 0.7).astype(np.uint8) * 255
    Image.fromarray(mask).save(tmp_path / "m.jpg")
    got = read_jpeg(tmp_path / "m.jpg")
    want = np.array(Image.open(tmp_path / "m.jpg"))
    np.testing.assert_array_equal(got > 0, want > 0)
    assert jpeg_size(tmp_path / "m.jpg") == Image.open(tmp_path / "m.jpg").size


ENCODE_SIZES = [(16, 16), (17, 23), (33, 47), (5, 3), FRAME_HW]


@pytest.mark.parametrize("quality", [50, 75, 90, 95])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("hw", ENCODE_SIZES)
def test_encode_jpeg_matches_pil(hw, channels, quality):
    """``encode_jpeg`` writes PIL's bytes: sizes on and off the MCU grid
    (968 rows are 121 luma block rows, so the last MCU row of a 4:2:0
    frame has a dummy block row), grey and RGB, four qualities. The small
    sizes also go back through the port's decoder to PIL's pixels."""
    arr = _image(*hw, channels, seed=quality)
    want = _jpeg_bytes(arr, quality=quality)
    got = encode_jpeg(arr, quality)
    assert got == want
    if hw != FRAME_HW:
        np.testing.assert_array_equal(decode_jpeg(got),
                                      np.array(Image.open(io.BytesIO(want))))


@pytest.mark.parametrize("seed", range(4))
def test_encode_jpeg_matches_pil_on_extremes(tmp_path, seed):
    """Random sizes and qualities 1-100 on white noise (the largest
    coefficients and runs), black-and-white noise and flat images, through
    ``write_jpeg``; quality 75 is PIL's default, which the scene writer's
    masks use."""
    rng = np.random.default_rng(seed)
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        shape = (h, w) if rng.integers(2) else (h, w, 3)
        kind = int(rng.integers(3))
        arr = (rng.integers(0, 256, shape) if kind == 0 else
               rng.integers(0, 2, shape) * 255 if kind == 1 else
               np.full(shape, rng.integers(256))).astype(np.uint8)
        quality = int(rng.integers(1, 101))
        write_jpeg(tmp_path / "e.jpg", arr, quality)
        assert (tmp_path / "e.jpg").read_bytes() == _jpeg_bytes(
            arr, quality=quality)
    arr = _image(9, 11, 1)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG")
    assert encode_jpeg(arr) == buf.getvalue()


def test_encode_jpeg_refuses_other_input():
    for bad in (np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4), np.uint16),
                np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError):
            encode_jpeg(bad)


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("sampling", ["grey", "4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("hw", [(17, 23), (33, 50)])
def test_progressive_jpeg_matches_pil(hw, sampling, optimize, restart):
    """PIL's ``progressive=True`` files (libjpeg's simple progression: DC
    first and refine scans, AC first scans with end-of-band runs and AC
    refine scans, interleaved DC, one component per AC scan), with its
    optimised tables (a DHT before each scan) or not, with restart markers
    every 3 MCUs or none, at sizes off the MCU grid: equal to PIL's
    pixels."""
    kw = dict(progressive=True, optimize=optimize, quality=90)
    if sampling != "grey":
        kw["subsampling"] = sampling
    if restart:
        kw["restart_marker_blocks"] = restart
    data = _jpeg_bytes(_image(*hw, 1 if sampling == "grey" else 3), **kw)
    assert b"\xff\xc2" in data
    assert (b"\xff\xdd" in data) == bool(restart)
    got = decode_jpeg(data)
    want = np.array(Image.open(io.BytesIO(data)))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _frame_image(h, w, seed=0, noise=2.0):
    """A smooth colour frame with sensor-like noise (what a camera gives a
    codec; its chroma varies slowly, so subsampling keeps it close)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    rgb = np.stack([128 + 100 * np.sin(3 * xx + 2 * yy),
                    128 + 90 * np.cos(4 * yy - xx),
                    100 + 80 * xx * yy + 40 * ((xx * 3).astype(int) % 2)], -1)
    rgb += rng.normal(0, noise, rgb.shape)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _ycc_planes(rgb):
    return [p.astype(np.uint8) for p in rgb_to_ycc(rgb)]


def _pil_pixels(data):
    """PIL's pixels of a JPEG byte string, its read buffer raised past the
    file's size (at PIL's default 64 KiB reads, libjpeg's arithmetic
    decoder, which cannot suspend, refuses any scan that crosses a read)."""
    block = ImageFile.MAXBLOCK
    ImageFile.MAXBLOCK = max(block, 2 * len(data))
    try:
        return np.asarray(Image.open(io.BytesIO(data)))
    finally:
        ImageFile.MAXBLOCK = block


def _assert_jpeg_equal(data):
    """The port's pixels of ``data`` equal PIL's."""
    want = _pil_pixels(data)
    got = decode_jpeg(data)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return got


def _assert_both_refuse(data, match):
    """PIL refuses ``data`` and so does the port, with a message that
    matches ``match``."""
    with pytest.raises((OSError, SyntaxError)):
        _pil_pixels(data)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        decode_jpeg(data)


def _file_parts(data):
    """A JPEG's marker segments after SOI as (marker, body), a scan's body
    holding its header and its entropy-coded data."""
    parts, pos = [], 2
    while data[pos + 1] != 0xD9:
        marker = data[pos + 1]
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] != 0
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        parts.append((marker, data[pos + 4:end]))
        pos = end
    return parts


def _rebuilt(parts, markers=b"", ids=None):
    """A file of ``parts`` with ``markers`` after SOI and, given ``ids``,
    its components renamed (old id -> new id) in the frame and the scans."""
    out = [b"\xff\xd8", markers]
    for marker, body in parts:
        body = bytearray(body)
        if ids and marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            for c in range(body[5]):
                body[6 + 3 * c] = ids[body[6 + 3 * c]]
        if ids and marker == 0xDA:
            for c in range(body[0]):
                body[1 + 2 * c] = ids[body[1 + 2 * c]]
        length = 4 + 2 * body[0] if marker == 0xDA else len(body)
        out.append(struct.pack(">BBH", 0xFF, marker, length + 2) + body)
    return b"".join(out) + b"\xff\xd9"


def _without_app(data):
    """The file's segments without its APP0 and APP14 markers."""
    return [p for p in _file_parts(data) if p[0] not in (0xE0, 0xEE)]


def _pil_jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def test_rgb_coded_jpeg_matches_pil():
    """The file PIL writes with ``keep_rgb=True`` (Adobe transform 0,
    component ids R, G, B): the planes are RGB, copied, not converted as
    YCbCr: equal to PIL on white noise and on a smooth ramp."""
    noise = np.random.default_rng(0).integers(0, 256, (32, 48, 3), np.uint8)
    ramp = np.stack(np.broadcast_arrays(
        np.arange(48)[None, :] * 5, np.arange(32)[:, None] * 7,
        np.full((32, 48), 90)), -1).astype(np.uint8)
    for arr in (noise, ramp):
        data = _pil_jpeg(arr, quality=90, keep_rgb=True)
        got = _assert_jpeg_equal(data)
        assert np.abs(got.astype(int) - arr).mean() < 40


RGB_VARIANTS = {
    # name: (APPn markers, component ids, how libjpeg reads the planes)
    "adobe-0": (adobe_app14(0), b"RGB", "RGB"),
    "adobe-1": (adobe_app14(1), b"RGB", "YCbCr"),
    "adobe-2": (adobe_app14(2), b"RGB", "YCbCr"),
    "adobe-7": (adobe_app14(7), b"RGB", "YCbCr"),
    "ids-RGB": (b"", b"RGB", "RGB"),
    "ids-123": (b"", b"\x01\x02\x03", "YCbCr"),
    "ids-789": (b"", b"\x07\x08\x09", "YCbCr"),
    "jfif-ids-RGB": (JFIF_APP0, b"RGB", "YCbCr"),
    "jfif-adobe-0": (JFIF_APP0 + adobe_app14(0), b"RGB", "YCbCr"),
    "short-jfif-ids-RGB": (_seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00"
                                      b"\x01\x00"), b"RGB", "RGB"),
    "short-adobe-1": (_seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"), b"RGB",
                      "RGB")}


@pytest.mark.parametrize("variant", sorted(RGB_VARIANTS))
def test_jpeg_colour_space_rule(variant):
    """jdapimin.c's colour-space rule on one set of 3 planes, its markers
    and ids changed: JFIF means YCbCr, else Adobe transform 0 RGB and any
    other YCbCr, else ids R, G, B mean RGB and any others YCbCr; a JFIF
    segment under 14 bytes or an Adobe one under 12 does not count. Equal
    to PIL, and RGB exactly where the planes are copied."""
    markers, ids, space = RGB_VARIANTS[variant]
    arr = _image(21, 30, 3)
    data = _rebuilt(_without_app(_pil_jpeg(arr, quality=95, keep_rgb=True)),
                    markers, dict(zip(b"RGB", ids)))
    got = _assert_jpeg_equal(data)
    planes = _assert_jpeg_equal(_rebuilt(_without_app(data), adobe_app14(0)))
    assert np.array_equal(got, planes) == (space == "RGB")


@pytest.mark.parametrize("hw", [(21, 30), (8, 8), (37, 53)])
def test_cmyk_jpeg_matches_pil(tmp_path, hw):
    """CMYK as PIL writes it (Adobe transform 0) and without the Adobe
    marker: PIL's mode CMYK, inverted (its CMYK;I raw mode), equal; the
    mode read from the header."""
    arr = np.random.default_rng(hw[0]).integers(0, 256, hw + (4,), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "CMYK").save(buf, "JPEG", quality=95)
    data = buf.getvalue()
    assert b"Adobe" in data
    for variant in (data, _rebuilt(_without_app(data))):
        got = _assert_jpeg_equal(variant)
        path = tmp_path / "c.jpg"
        path.write_bytes(variant)
        assert jpeg_mode(path) == image_mode(path) == Image.open(path).mode \
            == "CMYK"
    assert np.abs(got.astype(int) - arr).mean() < 8


@pytest.mark.parametrize("transform", [2, 1, 9])
def test_ycck_jpeg_matches_pil(transform):
    """Four components under Adobe transform 2 (or any but 0): YCCK, its
    Y, Cb, Cr through the YCbCr tables and K passed, as libjpeg's
    ycck_cmyk_convert gives them, then inverted by PIL; a CMYK file
    relabelled and a written YCCK one (4:2:0 chroma, K full), equal."""
    rng = np.random.default_rng(transform)
    cmyk = rng.integers(0, 256, (19, 26, 4), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=90)
    _assert_jpeg_equal(_rebuilt(_without_app(buf.getvalue()),
                                adobe_app14(transform)))
    rgb = _frame_image(33, 47)
    k = rng.integers(0, 256, (33, 47), np.uint8)
    data = write_huffman_jpeg(_ycc_planes(rgb) + [k],
                              [(2, 2), (1, 1), (1, 1), (2, 2)],
                              markers=adobe_app14(transform))
    got = _assert_jpeg_equal(data)
    assert np.abs(got[..., :3].astype(int) - rgb).mean() < 8
    assert np.abs(got[..., 3].astype(int) - (255 - k)).mean() < 20


SAMPLINGS = {
    "4:4:0": [(1, 2), (1, 1), (1, 1)], "4:1:1": [(4, 1), (1, 1), (1, 1)],
    "h4v2": [(4, 2), (1, 1), (1, 1)], "h1v4": [(1, 4), (1, 1), (1, 1)],
    "h1v4-h1v2": [(1, 4), (1, 2), (1, 1)],
    "h2v2-h1v2-h2v1": [(2, 2), (1, 2), (2, 1)],
    "h3v1": [(3, 1), (1, 1), (1, 1)], "4:2:0": [(2, 2), (1, 1), (1, 1)]}


@pytest.mark.parametrize("hw", [(17, 23), (9, 5), (33, 47)])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_chroma_sampling_matches_pil(sampling, hw):
    """Every integral sampling ratio, at odd sizes (chroma 1-2 samples wide
    included): the fancy triangles for 2 across, 2 down or both, else
    replication, as jdsample.c picks them; equal to PIL (and, at the
    largest size, close to the source)."""
    rgb = _frame_image(*hw)
    data = write_huffman_jpeg(_ycc_planes(rgb), SAMPLINGS[sampling],
                              markers=JFIF_APP0)
    got = _assert_jpeg_equal(data)
    if min(hw) > 16:
        assert np.abs(got.astype(int) - rgb).mean() < 12


@pytest.mark.parametrize("factors,match", [
    ([(3, 1), (2, 1), (1, 1)], "chroma sampling 2x1 of 3x1"),
    ([(2, 4), (1, 2), (1, 1)], "more than 10 blocks"),
    ([(5, 1), (1, 1), (1, 1)], "sampling factors outside 1-4")])
def test_jpeg_refuses_sampling(factors, match):
    """A non-integral ratio, an MCU of more than 10 blocks and a factor
    above 4: PIL refuses each, and so does the port."""
    data = write_huffman_jpeg(_ycc_planes(_frame_image(17, 23)), factors,
                              markers=JFIF_APP0)
    _assert_both_refuse(data, match)


def _scan_cuts(data):
    """The file cut after each of its scans but the last, ended by EOI."""
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return [data[:i] + b"\xff\xd9" for i in sos[1:]]


def test_progressive_jpeg_refuses_block_smoothing():
    """A progressive file cut after its first scans leaves low-frequency AC
    bits unsent, where libjpeg smooths the blocks: the port smooths them
    as jdcoefct.c does, equal to PIL."""
    data = _jpeg_bytes(_image(24, 32, 3), progressive=True, quality=90)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    cut = data[:sos[3]] + b"\xff\xd9"
    _assert_jpeg_equal(cut)


@pytest.mark.parametrize("hw", [(37, 53), (40, 16), (8, 24)])
@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("sampling", ["grey", "4:2:0", "4:4:4"])
def test_progressive_block_smoothing_matches_pil(sampling, restart, hw):
    """PIL's progressive files cut after every scan of its script (only DC
    known: the 5x5 DC estimates, DC re-estimated; some AC bits known: the
    AC01-AC02 estimates where the coefficient is still zero, capped at the
    bits unsent), grey, 4:2:0 and 4:4:4, with and without restarts, at
    widths of 2 blocks (the clamped neighbours) and with padding block
    rows: equal to PIL."""
    kw = dict(progressive=True, quality=90)
    if sampling != "grey":
        kw["subsampling"] = sampling
    if restart:
        kw["restart_marker_blocks"] = restart
    data = _pil_jpeg(_image(*hw, 1 if sampling == "grey" else 3), **kw)
    for cut in _scan_cuts(data):
        _assert_jpeg_equal(cut)


ARITH_CASES = {"grey": ([(1, 1)], None), "4:2:0": ([(2, 2), (1, 1), (1, 1)],
                                                 JFIF_APP0),
               "4:4:0": ([(1, 2), (1, 1), (1, 1)], JFIF_APP0)}


@pytest.mark.parametrize("dac", [None, {"dc": (2, 4), "ac": 10}])
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("kind", sorted(ARITH_CASES))
def test_arithmetic_jpeg_matches_pil(kind, progressive, restart, dac):
    """Arithmetic-coded files (SOF9 one interleaved scan; SOF10 libjpeg's
    progression: DC first and refine, AC first and refine), restart
    intervals resetting the statistics, a DAC segment's conditioning:
    equal to PIL, and close to the source (so the writer's table is the
    one libjpeg decodes with)."""
    factors, markers = ARITH_CASES[kind]
    rgb = _frame_image(23, 37, seed=len(kind))
    planes = [rgb[..., 1]] if kind == "grey" else _ycc_planes(rgb)
    data = write_arithmetic_jpeg(planes, factors, markers=markers or b"",
                                 restart=restart, progressive=progressive,
                                 dac=dac)
    assert (b"\xff\xcc" in data) == bool(dac)
    got = _assert_jpeg_equal(data)
    assert np.abs(got.astype(int) - (rgb[..., 1] if kind == "grey"
                                     else rgb)).mean() < 6


def test_arithmetic_progressive_smoothing_matches_pil():
    """An arithmetic progressive file cut after every scan: block
    smoothing as for Huffman ones, equal to PIL."""
    data = write_arithmetic_jpeg(_ycc_planes(_frame_image(40, 56, noise=8)),
                                 [(2, 2), (1, 1), (1, 1)], markers=JFIF_APP0,
                                 progressive=True, restart=3)
    for cut in _scan_cuts(data):
        _assert_jpeg_equal(cut)


def test_arithmetic_jpeg_past_pil_read_buffer():
    """An arithmetic-coded scan longer than PIL's 64 KiB reads: PIL at its
    defaults refuses it (libjpeg's arithmetic decoder cannot suspend at a
    read's end), and reads it with a larger buffer; the port reads it
    whole, equal to the latter."""
    data = write_arithmetic_jpeg([_image(320, 480, 1)], [(1, 1)])
    assert len(data) > ImageFile.MAXBLOCK
    with pytest.raises(OSError):
        np.asarray(Image.open(io.BytesIO(data)))
    _assert_jpeg_equal(data)


def _marker_file(marker: int) -> bytes:
    """SOI, then a marker segment of its own, then EOI."""
    body = bytes([8, 0, 16, 0, 16, 1, 1, 0x11, 0]) if marker != 0xCC else (
        bytes([0x00, 0x10]))
    return (b"\xff\xd8" + struct.pack(">BBH", 0xFF, marker, len(body) + 2)
            + body + b"\xff\xd9")


@pytest.mark.parametrize("marker,process", [
    (0xC5, "hierarchical JPEG (SOF5)"), (0xC6, "hierarchical JPEG (SOF6)"),
    (0xC7, "hierarchical JPEG (SOF7)"),
    (0xCD, "hierarchical arithmetic-coded JPEG (SOF13)"),
    (0xCE, "hierarchical arithmetic-coded JPEG (SOF14)"),
    (0xCF, "hierarchical arithmetic-coded JPEG (SOF15)")])
def test_jpeg_refuses_process(marker, process):
    """The processes libjpeg-turbo refuses as PIL drives it raise, naming
    the process: the hierarchical ones, Huffman and arithmetic."""
    with pytest.raises(NotImplementedError, match=re.escape(process)):
        decode_jpeg(_marker_file(marker))


def _with_frame(data, marker=None, precision=None, height=None):
    """The file with its frame header's marker, precision or height
    changed."""
    parts = []
    for m, body in _file_parts(data):
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xCC):
            body = bytearray(body)
            if precision is not None:
                body[0] = precision
            if height is not None:
                body[1:3] = struct.pack(">H", height)
            m = marker or m
        parts.append((m, bytes(body)))
    return _rebuilt(parts)


def test_jpeg_refusals_match_pil():
    """What PIL refuses, the port refuses, naming it: a lossless file
    marked arithmetic-coded (SOF11, which libjpeg-turbo does not decode),
    12-bit precision, a height left to a DNL marker, and two components."""
    grey = _image(16, 16, 1)
    lossless = write_lossless_jpeg([grey], 1)
    _assert_both_refuse(_with_frame(lossless, marker=0xCB),
                        re.escape("arithmetic-coded lossless JPEG (SOF11)"))
    baseline = _pil_jpeg(grey, quality=90)
    _assert_both_refuse(_with_frame(baseline, precision=12),
                        "12-bit JPEG precision")
    _assert_both_refuse(_with_frame(baseline, height=0), "DNL marker")
    _assert_both_refuse(write_huffman_jpeg([grey, grey], [(1, 1), (1, 1)]),
                        "JPEG with 2 components")


@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_jpeg_matches_pil(psv, pt):
    """Lossless (SOF3) grey with each predictor and point transforms 0 and
    2, restart intervals of 3 rows (each re-predicts its first row from
    2^(P-Pt-1)): equal to PIL and to the samples, their low Pt bits 0."""
    grey = _image(19, 26, 1)
    for restart in (0, 3):
        got = _assert_jpeg_equal(write_lossless_jpeg([grey], psv, pt,
                                                     restart_rows=restart))
        np.testing.assert_array_equal(got, (grey >> pt) << pt)


@pytest.mark.parametrize("psv", [1, 4, 6, 7])
def test_lossless_colour_jpeg_matches_pil(psv):
    """Lossless colour: 3 components with ids 1, 2, 3 and no marker are RGB
    in a lossless file (YCbCr in a DCT one), as are ids R, G, B and any
    others; one interleaved scan or one scan a component, with restarts;
    CMYK; equal to PIL and to the samples. YCbCr ones (JFIF, Adobe
    transform 1) and YCCK ones PIL refuses: so does the port."""
    rgb = _image(17, 22, 3)
    planes = list(np.moveaxis(rgb, -1, 0))
    for kw in (dict(), dict(ids=[82, 71, 66]), dict(ids=[7, 8, 9]),
               dict(interleaved=False, restart_rows=4),
               dict(restart_rows=2, pt=1)):
        got = _assert_jpeg_equal(write_lossless_jpeg(planes, psv, **kw))
        pt = kw.get("pt", 0)
        np.testing.assert_array_equal(got, (rgb >> pt) << pt)
    cmyk = np.random.default_rng(psv).integers(0, 256, (9, 11, 4), np.uint8)
    got = _assert_jpeg_equal(write_lossless_jpeg(list(np.moveaxis(cmyk, -1, 0)),
                                                 psv))
    np.testing.assert_array_equal(got, 255 - cmyk)
    for markers in (JFIF_APP0, adobe_app14(1)):
        _assert_both_refuse(write_lossless_jpeg(planes, psv, markers=markers),
                            "lossless JPEG in YCbCr")
    _assert_both_refuse(write_lossless_jpeg(list(np.moveaxis(cmyk, -1, 0)),
                                            psv, markers=adobe_app14(2)),
                        "lossless JPEG in YCCK")


def test_lossless_restart_must_cover_rows():
    """A lossless restart interval that is not a whole number of MCU rows:
    PIL refuses it, and so does the port."""
    data = write_lossless_jpeg([_image(8, 10, 1)], 1, restart_rows=2)
    data = data.replace(b"\xff\xdd\x00\x04\x00\x14", b"\xff\xdd\x00\x04\x00\x0f")
    _assert_both_refuse(data, "not a multiple")


def test_image_mode_matches_pil(tmp_path):
    """``image_mode`` of the PNGs and JPEGs the readers open: PIL's mode."""
    for name, arr, kw in (("l.jpg", _image(9, 11, 1), {}),
                          ("rgb.jpg", _image(9, 11, 3), {}),
                          ("l.png", _image(9, 11, 1), {}),
                          ("rgba.png", np.concatenate(
                              [_image(9, 11, 3), _image(9, 11, 1)[..., None]],
                              -1), {}),
                          ("b.png", _image(9, 11, 1) > 100, {})):
        Image.fromarray(arr).save(tmp_path / name, **kw)
    Image.fromarray(_image(9, 11, 3)).convert("CMYK").save(tmp_path / "c.jpg")
    Image.fromarray(_image(9, 11, 3)).quantize(8).save(tmp_path / "p.png")
    for colour, depth in ((0, 16), (2, 16), (4, 8), (4, 16), (6, 16)):
        channels = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
        samples = np.random.default_rng(depth).integers(
            0, 1 << depth, (5, 6, channels))
        (tmp_path / f"c{colour}d{depth}.png").write_bytes(
            _png_form(samples, colour, depth, interlace=False))
    for path in sorted(tmp_path.iterdir()):
        assert image_mode(path) == Image.open(path).mode, path.name


@pytest.mark.parametrize("out", [(13, 17), (40, 50)])
def test_cmyk_resize_and_grey_match_pil(out):
    """A CMYK frame resized LANCZOS as CMYK (no premultiplied alpha, which
    an RGBA array of the same shape gets) and greyed through RGB, as PIL
    does: equal; its RGB conversion equal to PIL's."""
    cmyk = np.random.default_rng(3).integers(0, 256, (21, 30, 4), np.uint8)
    cmyk[..., 3] = np.random.default_rng(4).choice([0, 7, 128, 255], (21, 30))
    im = Image.fromarray(cmyk, "CMYK")
    want = np.asarray(im.resize(out[::-1], Image.LANCZOS))
    np.testing.assert_array_equal(resize_pil(cmyk, out, True, "CMYK"), want)
    np.testing.assert_array_equal(resize_lanczos_uint8(cmyk, out, "CMYK"),
                                  want)
    assert not np.array_equal(resize_lanczos_uint8(cmyk, out), want)
    np.testing.assert_array_equal(to_grey_pil(cmyk, mode="CMYK"),
                                  np.asarray(im.convert("L")))
    np.testing.assert_array_equal(cmyk_to_rgb(cmyk),
                                  np.asarray(im.convert("RGB")))


NEAREST_CASES = [((37, 53), (64, 96)), ((64, 96), (13, 11)),
                 ((64, 96), (37, 53)), ((480, 640), (97, 129)),
                 ((7, 5), (100, 7)), ((64, 96), (3, 200))]


@pytest.mark.parametrize("hw,out", NEAREST_CASES)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.int16,
                                   np.float32])
def test_resize_nearest_matches_pil(hw, out, dtype):
    """Non-integer up and down ratios, for the dtypes the readers and the
    preprocessing scripts resize (uint8 L, uint16 I;16, int32 and int16 as
    PIL's mode I, float32 as its mode F: ScanNet depth)."""
    rng = np.random.default_rng(0)
    if dtype == np.float32:
        arr = rng.uniform(-500, 70000, hw).astype(dtype)
    else:
        info = np.iinfo(dtype)
        arr = rng.integers(max(info.min, -500), min(info.max, 70000),
                           hw).astype(dtype)
    want = np.array(Image.fromarray(arr).resize(out[::-1], Image.NEAREST))
    got = resize_nearest(arr, out)
    np.testing.assert_array_equal(got, want.astype(got.dtype))


LANCZOS_CASES = [((37, 53), (64, 96)), ((480, 640), (64, 96)),
                 ((64, 96), (13, 11)), ((7, 5), (100, 7)),
                 ((64, 96), (64, 40)), ((64, 96), (30, 96))]


@pytest.mark.parametrize("hw,out", LANCZOS_CASES)
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_resize_lanczos_matches_pil(hw, out, mode):
    """PIL's two fixed-point passes, only one where one axis keeps its
    size; RGBA (alpha 0, 255 and between) premultiplied as PIL does."""
    rng = np.random.default_rng(1)
    channels = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    arr = _image(*hw, min(channels, 3), seed=2)
    if mode == "RGBA":
        alpha = rng.choice([0, 255, 7, 128, 200], hw).astype(np.uint8)
        arr = np.concatenate([arr, alpha[..., None]], -1)
    want = np.array(Image.fromarray(arr).resize(out[::-1], Image.LANCZOS))
    np.testing.assert_array_equal(resize_lanczos_uint8(arr, out), want)


@pytest.mark.parametrize("hw,out", [((37, 53), (64, 96)),
                                    ((64, 96), (37, 53)),
                                    ((480, 640), (256, 384)),
                                    ((7, 5), (100, 7)), ((24, 32), (24, 32))])
def test_resize_bilinear_matches_jax(hw, out):
    rng = np.random.default_rng(2)
    arr = rng.random((5,) + hw).astype(np.float32)
    want = np.asarray(jax.image.resize(arr, (5,) + out, "bilinear"))
    got = resize_bilinear_chw(arr, out)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "1", "I;16"])
def test_to_grey_pil_matches_convert(mode):
    rng = np.random.default_rng(4)
    channels = {"LA": 2, "RGB": 3, "RGBA": 4}.get(mode, 1)
    arr = rng.integers(0, 256, (17, 19, channels)).astype(np.uint8)
    arr = arr[..., 0] if channels == 1 else arr
    if mode == "1":
        arr = arr > 127
    elif mode == "I;16":
        arr = rng.integers(0, 600, (17, 19)).astype(np.uint16)
    im = (Image.fromarray(arr, mode) if mode in ("LA", "RGBA")
          else Image.fromarray(arr))
    assert im.mode == mode
    np.testing.assert_array_equal(to_grey_pil(arr),
                                  np.array(im.convert("L")))


@pytest.mark.parametrize("mode", ["LA", "RGBA"])
def test_resize_lanczos_with_alpha_matches_pil(mode):
    """LA is resized premultiplied, as PIL's La, like RGBA."""
    rng = np.random.default_rng(6)
    channels = 2 if mode == "LA" else 4
    arr = rng.integers(0, 256, (37, 53, channels)).astype(np.uint8)
    arr[..., -1] = rng.choice([0, 255, 7, 128, 200], (37, 53))
    want = np.array(Image.fromarray(arr, mode).resize((31, 20), Image.LANCZOS))
    np.testing.assert_array_equal(resize_lanczos_uint8(arr, (20, 31)), want)


@pytest.mark.parametrize("suffix,kw", [("png", {}), ("jpg", {"quality": 95}),
                                       ("jpg", {"progressive": True})])
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_read_image_matches_pil(tmp_path, suffix, kw, mode):
    """``read_image`` and ``image_size`` of the files the preprocessing
    scripts open, and ``resize_pil`` of what they read: a copy at the same
    size (PIL's ``resize`` copies), LANCZOS or NEAREST otherwise."""
    arr = _image(21, 34, 1 if mode == "L" else 3)
    path = tmp_path / f"f.{suffix}"
    Image.fromarray(arr).save(path, **kw)
    im = Image.open(path)
    got = read_image(path)
    np.testing.assert_array_equal(got, np.asarray(im))
    assert image_size(path) == im.size
    same = resize_pil(got, (21, 34), lanczos=True)
    assert same is not got
    np.testing.assert_array_equal(same, got)
    for lanczos, resample in ((True, Image.LANCZOS), (False, Image.NEAREST)):
        np.testing.assert_array_equal(
            resize_pil(got, (13, 50), lanczos),
            np.array(im.resize((50, 13), resample)))


@pytest.mark.parametrize("form", ["P", "P;4", "RGB;16", "LA;16", "RGBA;16"])
def test_read_image_palette_and_16_bit_colour(tmp_path, form):
    """Palette PNGs (as PIL writes them) and 16-bit colour: ``read_image``
    is PIL's indices or 8-bit high bytes, ``image_palette`` PIL's palette,
    the generic script's resize (NEAREST for a palette, which PIL forces
    on mode P) and ``to_grey_pil`` through the palette equal to PIL's."""
    path = tmp_path / "f.png"
    if form.startswith("P"):
        im = Image.fromarray(_image(21, 34, 3)).quantize(16)
        im.save(path, **({"bits": 4} if form == "P;4" else {}))
    else:
        channels = {"RGB;16": 3, "LA;16": 2, "RGBA;16": 4}[form]
        colour = {3: 2, 2: 4, 4: 6}[channels]
        samples = np.random.default_rng(5).integers(0, 65536,
                                                    (21, 34, channels))
        path.write_bytes(_png_form(samples, colour, 16, interlace=False))
    im = Image.open(path)
    got = read_image(path)
    assert got.dtype == np.asarray(im).dtype
    np.testing.assert_array_equal(got, np.asarray(im))
    palette = image_palette(path)
    if im.mode == "P":
        want = np.array(im.getpalette()[:3 * len(palette)]).reshape(-1, 3)
        np.testing.assert_array_equal(palette, want)
    else:
        assert palette is None
    resized = resize_pil(got, (13, 50), lanczos=palette is None)
    np.testing.assert_array_equal(
        resized, np.array(im.resize((50, 13), Image.LANCZOS)))
    np.testing.assert_array_equal(to_grey_pil(got, palette),
                                  np.array(im.convert("L")))


@pytest.mark.parametrize("fmt,name", [("GIF", "GIF"), ("BMP", "BMP"),
                                      ("TIFF", "TIFF"), ("WEBP", "WebP")])
def test_read_image_names_other_formats(tmp_path, fmt, name):
    path = tmp_path / "f.img"
    try:
        Image.fromarray(_image(8, 8, 3)).save(path, fmt)
    except (KeyError, OSError):
        pytest.skip(f"this Pillow cannot write {fmt}")
    with pytest.raises(ValueError, match=name):
        read_image(path)


def frame_encode_seconds(repeats: int = 3):
    """Median host seconds of ``encode_jpeg`` on a 968x1296 4:2:0 frame at
    quality 90 (the raw ScanNet capture's) and 95 (the scene writer's)."""
    arr = _image(*FRAME_HW, 3)
    out = {}
    for quality in (90, 95):
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            encode_jpeg(arr, quality)
            times.append(time.perf_counter() - t0)
        out[quality] = float(np.median(times))
    return out


def frame_decode_seconds(repeats: int = 3) -> float:
    """Median host seconds of ``decode_jpeg`` on a 968x1296 quality-95
    4:2:0 frame (PIL-encoded)."""
    data = _jpeg_bytes(_image(*FRAME_HW, 3), quality=95)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        decode_jpeg(data)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), len(data)


if __name__ == "__main__":
    for quality, seconds in frame_encode_seconds().items():
        print(f"encode_jpeg: {FRAME_HW[0]}x{FRAME_HW[1]} quality-{quality} "
              f"4:2:0 frame: {seconds:.3f} s (median of 3, host CPU)")
    seconds, size = frame_decode_seconds()
    print(f"decode_jpeg: {FRAME_HW[0]}x{FRAME_HW[1]} quality-95 4:2:0 frame "
          f"({size} bytes): {seconds:.3f} s (median of 3, host CPU)")
