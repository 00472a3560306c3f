"""A baseline JPEG decoder in numpy: the port's stand-in for PIL's decoder,
which the card's machine does not have.

It decodes what the repository's scene writer stores
(``data/preprocessing/common.py::SceneWriter``: PIL at quality 95 with
4:2:0 chroma, and grey ``invalid/*.jpg`` masks), and in general
baseline and extended sequential Huffman files (SOF0, SOF1) of 8-bit
precision with 1 component, or 3 YCbCr components sampled 4:4:4, 4:2:2
or 4:2:0, of any size, with or without restart intervals.

It follows libjpeg-turbo (API 6.2), which PIL decodes with, so that its
pixels are PIL's:

- the "islow" integer inverse DCT of ``jidctint.c`` (13 constant bits,
  2 pass-1 bits) with its range-limiting table;
- the "fancy" triangle upsampling of ``jdsample.c`` for h2v1 and h2v2
  chroma (rounding biases 1/2 and 8/7), and plain replication where the
  chroma is at most 2 samples wide, as ``jdsample.c`` chooses;
- the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` (16 scale bits).

Progressive, lossless, hierarchical and arithmetic-coded files raise
``NotImplementedError`` naming the process. The Huffman decoding is a plain
Python loop (about 1 s for a 968x1296 quality-95 frame on one host core);
dequantisation, the IDCT, upsampling and colour conversion run in numpy.
"""
from __future__ import annotations

import struct
from array import array
from pathlib import Path

import numpy as np

# zig-zag position -> natural (row-major) position of a coefficient
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_UNSUPPORTED_SOF = {
    0xC2: "progressive JPEG (SOF2)", 0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)", 0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded JPEG (SOF10)", 0xCB: "arithmetic-coded JPEG "
    "(SOF11)", 0xCC: "arithmetic-coded JPEG (DAC)", 0xCD: "arithmetic-coded "
    "JPEG (SOF13)", 0xCE: "arithmetic-coded JPEG (SOF14)",
    0xCF: "arithmetic-coded JPEG (SOF15)"}

# jidctint.c: CONST_BITS 13, PASS1_BITS 2, FIX(x) = round(x * 2^13)
_CONST_BITS, _PASS1_BITS = 13, 2
_FIX_0_298631336, _FIX_0_390180644, _FIX_0_541196100 = 2446, 3196, 4433
_FIX_0_765366865, _FIX_0_899976223, _FIX_1_175875602 = 6270, 7373, 9633
_FIX_1_501321110, _FIX_1_847759065, _FIX_1_961570560 = 12299, 15137, 16069
_FIX_2_053119869, _FIX_2_562915447, _FIX_3_072711026 = 16819, 20995, 25172


def _idct_range_limit() -> np.ndarray:
    """jdmaster.c::prepare_range_limit_table, post-IDCT half, indexed by
    ``x & 1023`` for an IDCT output x centred on 0: x + 128 clamped to
    [0, 255] for |x| < 512 (the table wraps beyond, as libjpeg's does)."""
    v = np.arange(1024)
    return np.where(v < 128, v + 128, np.where(v < 512, 255, np.where(
        v < 896, 0, v - 896))).astype(np.uint8)


_RANGE_LIMIT = _idct_range_limit()


def _idct_1d(x):
    """The even/odd butterfly of jidctint.c on x[0..7] (int64 arrays), before
    the final descale; returns the 8 outputs."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _FIX_0_541196100
    tmp2 = z1 + z3 * -_FIX_1_847759065
    tmp3 = z1 + z2 * _FIX_0_765366865
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _FIX_1_175875602
    t0 = t0 * _FIX_0_298631336
    t1 = t1 * _FIX_2_053119869
    t2 = t2 * _FIX_3_072711026
    t3 = t3 * _FIX_1_501321110
    z1 = z1 * -_FIX_0_899976223
    z2 = z2 * -_FIX_2_562915447
    z3 = z3 * -_FIX_1_961570560 + z5
    z4 = z4 * -_FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """jidctint.c::jpeg_idct_islow on every block: ``coefs`` [N, 64] in
    natural order, ``quant`` [64] natural order -> [N, 8, 8] uint8 samples."""
    x = (coefs.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (along the vertical-frequency axis) into the workspace
    shift = _CONST_BITS - _PASS1_BITS
    ws = np.stack([(v + (1 << (shift - 1))) >> shift
                   for v in _idct_1d([x[:, k, :] for k in range(8)])], axis=1)
    # pass 2: rows, then descale and range-limit
    shift = _CONST_BITS + _PASS1_BITS + 3
    out = np.stack([(v + (1 << (shift - 1))) >> shift
                    for v in _idct_1d([ws[:, :, k] for k in range(8)])],
                   axis=2)
    return _RANGE_LIMIT[out & 1023]


def _upsample_h2(plane: np.ndarray) -> np.ndarray:
    """jdsample.c::h2v1_fancy_upsample on [rows, w] samples -> [rows, 2w]."""
    p = plane.astype(np.int32)
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    # the first and last output columns copy the sample
    out[:, 0], out[:, -1] = p[:, 0], p[:, -1]
    return out.astype(np.uint8)


def _upsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """jdsample.c::h2v2_fancy_upsample on [h, w] samples -> [2h, 2w], with
    the rows above the first and below the last replicated (jdmainct.c)."""
    p = plane.astype(np.int32)
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
    for v, near in ((0, above), (1, below)):
        col = 3 * p + near            # the vertical triangle, x4
        last = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
        nxt = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
        out[v::2, 0::2] = (3 * col + last + 8) >> 4
        out[v::2, 1::2] = (3 * col + nxt + 7) >> 4
        out[v::2, 0] = (4 * col[:, 0] + 8) >> 4
        out[v::2, -1] = (4 * col[:, -1] + 7) >> 4
    return out.astype(np.uint8)


def _ycc_tables():
    """jdcolor.c::build_ycc_rgb_table: 16 scale bits."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c::ycc_rgb_convert of uint8 planes -> [..., 3] uint8."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


class _Huffman:
    """A Huffman table as lookup lists over the next 16 bits of the stream.

    ``length`` and ``symbol``: the code length (0 for bit patterns that
    start no code) and its symbol. ``fast_len``, ``fast_run`` and
    ``fast_val``: where the code and the value bits that follow it fit in
    the 16 bits, the bits they take together, the zero run before the
    coefficient (AC tables; -1 for end of block) and the value (the
    coefficient, or the DC difference: 0 for symbol 0), so that one lookup
    decodes them (0 in ``fast_len`` otherwise)."""

    def __init__(self, counts, symbols):
        self.length = [0] * 65536
        self.symbol = [0] * 65536
        self.fast_len = [0] * 65536
        self.fast_run = [0] * 65536
        self.fast_val = [0] * 65536
        code, k = 0, 0
        for bits in range(1, 17):
            for _ in range(counts[bits - 1]):
                sym = symbols[k]
                lo = code << (16 - bits)
                hi = (code + 1) << (16 - bits)
                self.length[lo:hi] = [bits] * (hi - lo)
                self.symbol[lo:hi] = [sym] * (hi - lo)
                self._fast(code, bits, sym)
                code += 1
                k += 1
            code <<= 1

    def _fast(self, code: int, bits: int, sym: int) -> None:
        run, size = sym >> 4, sym & 15
        if bits + size > 16:
            return
        if size == 0 and run != 15:       # end of block (AC) or DC diff 0
            lo = code << (16 - bits)
            hi = (code + 1) << (16 - bits)
            self.fast_len[lo:hi] = [bits] * (hi - lo)
            self.fast_run[lo:hi] = [-1 if sym == 0 else 0] * (hi - lo)
            return
        rest = 16 - bits - size
        for v in range(1 << size):
            value = v if size == 0 or v >= 1 << (size - 1) else v + 1 - (1 << size)
            lo = ((code << size) | v) << rest
            hi = lo + (1 << rest)
            self.fast_len[lo:hi] = [bits + size] * (hi - lo)
            self.fast_run[lo:hi] = [run] * (hi - lo)
            self.fast_val[lo:hi] = [value] * (hi - lo)


def _windows(data: bytes):
    """For every bit position p of ``data``: the 32 bits that start at p, as
    a memoryview of uint32 (zeros past the end)."""
    b = np.frombuffer(data + b"\0" * 5, np.uint8).astype(np.uint64)
    n = len(data)
    v = ((b[:n] << 32) | (b[1:n + 1] << 24) | (b[2:n + 2] << 16)
         | (b[3:n + 3] << 8) | b[4:n + 4])
    shifts = np.arange(8, 0, -1, dtype=np.uint64)
    win = ((v[:, None] >> shifts[None, :]) & np.uint64(0xFFFFFFFF))
    return memoryview(win.astype(np.uint32).reshape(-1)).cast("B").cast("I")


def _split_scan(data: bytes, start: int):
    """The entropy-coded segments of a scan that begins at ``data[start]``:
    bytes un-stuffed (FF00 -> FF) and split at restart markers. Returns
    (segments, offset of the marker that ends the scan)."""
    segments, current, pos = [], bytearray(), start
    while True:
        nxt = data.find(b"\xff", pos)
        if nxt < 0:
            raise ValueError("JPEG scan is not terminated by a marker")
        current += data[pos:nxt]
        marker = data[nxt + 1] if nxt + 1 < len(data) else 0xD9
        if marker == 0x00:
            current.append(0xFF)
            pos = nxt + 2
        elif marker == 0xFF:            # fill byte before a marker
            pos = nxt + 1
        elif 0xD0 <= marker <= 0xD7:
            segments.append(bytes(current))
            current = bytearray()
            pos = nxt + 2
        else:
            segments.append(bytes(current))
            return segments, nxt


def _decode_scan(segments, offsets, blocks, restart: int):
    """Huffman-decode one scan into the components' coefficient stores, in
    natural order. ``blocks`` lists the blocks of an MCU as (coefficient
    store, DC table, AC table, index of the component in the scan), and
    ``offsets[m]`` the block index in its store of each of MCU m's blocks.
    ``restart`` is the restart interval in MCUs (0: none)."""
    natural = NATURAL_ORDER.tolist()
    n_comp = max(b[3] for b in blocks) + 1
    preds = [0] * n_comp
    seg_bounds, data = [], bytearray()
    for seg in segments:
        seg_bounds.append(len(data) * 8)
        data += seg
    win = _windows(bytes(data))
    seg_index, pos = 0, 0
    for m in range(len(offsets)):
        if restart and m and m % restart == 0:
            seg_index += 1
            if seg_index >= len(seg_bounds):
                raise ValueError("JPEG scan ends before its last restart "
                                 "interval")
            pos = seg_bounds[seg_index]
            preds = [0] * n_comp
        for (store, dc, ac, ci), off in zip(blocks, offsets[m]):
            base = off * 64
            # DC difference: the one-lookup path, else code then bits
            top = win[pos] >> 16
            n = dc.fast_len[top]
            if n:
                pos += n
                preds[ci] += dc.fast_val[top]
            else:
                length = dc.length[top]
                if not length:
                    raise ValueError("corrupt JPEG data: bad Huffman code")
                s = dc.symbol[top]
                pos += length
                r = win[pos] >> (32 - s)
                pos += s
                if r < (1 << (s - 1)):
                    r += 1 - (1 << s)
                preds[ci] += r
            store[base] = preds[ci]
            # AC coefficients: the one-lookup path, else code then bits
            ac_len, ac_sym = ac.length, ac.symbol
            f_len, f_run, f_val = ac.fast_len, ac.fast_run, ac.fast_val
            k = 1
            while k < 64:
                top = win[pos] >> 16
                n = f_len[top]
                if n:
                    pos += n
                    r = f_run[top]
                    if r < 0:
                        break
                    k += r
                    if k > 63:
                        raise ValueError("corrupt JPEG data: coefficient "
                                         "index past 63")
                    store[base + natural[k]] = f_val[top]
                    k += 1
                    continue
                length = ac_len[top]
                if not length:
                    raise ValueError("corrupt JPEG data: bad Huffman code")
                rs = ac_sym[top]
                pos += length
                s = rs & 15
                if s:
                    k += rs >> 4
                    r = win[pos] >> (32 - s)
                    pos += s
                    if r < (1 << (s - 1)):
                        r += 1 - (1 << s)
                    if k > 63:
                        raise ValueError("corrupt JPEG data: coefficient "
                                         "index past 63")
                    store[base + natural[k]] = r
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG byte string -> [H, W] uint8 (1 component) or
    [H, W, 3] uint8 RGB (3 components, YCbCr)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    quant, dc_tables, ac_tables = {}, {}, {}
    frame, comps, restart = None, [], 0
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        pos += 2
        if marker == 0xD9:
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2:pos + length]
        pos += length
        if marker in _UNSUPPORTED_SOF:
            raise NotImplementedError(_UNSUPPORTED_SOF[marker])
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = struct.unpack(">64H", seg[i + 1:i + 129])
                    i += 129
                else:
                    vals = tuple(seg[i + 1:i + 65])
                    i += 65
                table = np.zeros(64, np.int64)
                table[NATURAL_ORDER] = vals
                quant[tq] = table
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                n = sum(counts)
                table = _Huffman(counts, list(seg[i + 17:i + 17 + n]))
                (ac_tables if tc else dc_tables)[th] = table
                i += 17 + n
        elif marker in (0xC0, 0xC1):
            precision, height, width, n = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise NotImplementedError(f"{precision}-bit JPEG precision")
            if height == 0:
                raise NotImplementedError("JPEG height given by a DNL marker")
            frame = (height, width)
            comps = [{"id": seg[6 + 3 * c], "h": seg[7 + 3 * c] >> 4,
                      "v": seg[7 + 3 * c] & 15, "tq": seg[8 + 3 * c]}
                     for c in range(n)]
        elif marker == 0xDD:
            restart = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            pos = _read_scan(data, pos, seg, frame, comps, dc_tables,
                             ac_tables, restart)
        # APPn, COM and anything else with a length: skipped
    if frame is None:
        raise ValueError("JPEG: no frame header")
    return _reconstruct(frame, comps, quant)


def _geometry(frame, comps):
    """(hmax, vmax, MCUs across, MCUs down) of the frame."""
    height, width = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    return (hmax, vmax, -(-width // (8 * hmax)), -(-height // (8 * vmax)))


def _read_scan(data, pos, header, frame, comps, dc_tables, ac_tables,
               restart) -> int:
    """Decode the scan whose SOS header is ``header`` into the components'
    coefficient stores; returns the offset of the marker after the scan."""
    height, width = frame
    hmax, vmax, mcux, mcuy = _geometry(frame, comps)
    n = header[0]
    by_id = {c["id"]: (i, c) for i, c in enumerate(comps)}
    scan = []
    for k in range(n):
        ci, comp = by_id[header[1 + 2 * k]]
        td, ta = header[2 + 2 * k] >> 4, header[2 + 2 * k] & 15
        scan.append((ci, comp, dc_tables[td], ac_tables[ta]))
    ss, se = header[1 + 2 * n], header[2 + 2 * n]
    if ss != 0 or se != 63:
        raise NotImplementedError("progressive JPEG (spectral selection)")
    for ci, comp, _, _ in scan:
        if "store" not in comp:
            comp["blocks"] = (mcuy * comp["v"], mcux * comp["h"])
            comp["store"] = array("i", bytes(4 * 64 * comp["blocks"][0]
                                             * comp["blocks"][1]))
    if n == 1:
        # non-interleaved: one block per MCU over the component's own size
        ci, comp, dc, ac = scan[0]
        bw = -(-(-(-width * comp["h"] // hmax)) // 8)
        bh = -(-(-(-height * comp["v"] // vmax)) // 8)
        stride = comp["blocks"][1]
        offsets = [(y * stride + x,) for y in range(bh) for x in range(bw)]
        blocks = [(comp["store"], dc, ac, 0)]
    else:
        blocks, rel = [], []
        for k, (ci, comp, dc, ac) in enumerate(scan):
            stride = comp["blocks"][1]
            for v in range(comp["v"]):
                for h in range(comp["h"]):
                    blocks.append((comp["store"], dc, ac, k))
                    rel.append((k, v, h, stride))
        offsets = []
        for my in range(mcuy):
            for mx in range(mcux):
                offsets.append(tuple(
                    (my * scan[k][1]["v"] + v) * stride
                    + mx * scan[k][1]["h"] + h
                    for k, v, h, stride in rel))
    segments, end = _split_scan(data, pos)
    _decode_scan(segments, offsets, blocks, restart)
    return end


def _reconstruct(frame, comps, quant) -> np.ndarray:
    """Dequantise, inverse-DCT, upsample and colour-convert."""
    height, width = frame
    hmax, vmax, _, _ = _geometry(frame, comps)
    planes = []
    for comp in comps:
        if "store" not in comp:
            raise ValueError(f"JPEG component {comp['id']} has no scan")
        bh, bw = comp["blocks"]
        coefs = np.frombuffer(comp["store"], np.int32).reshape(-1, 64)
        pixels = idct_islow(coefs, quant[comp["tq"]])
        plane = pixels.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(bh * 8, bw * 8)
        # the component's own size (libjpeg's downsampled_width/height)
        ch = -(-height * comp["v"] // vmax)
        cw = -(-width * comp["h"] // hmax)
        plane = plane[:ch, :cw]
        if len(comps) > 1:
            plane = _upsample(plane, hmax // comp["h"], vmax // comp["v"],
                              (comp["h"], comp["v"], hmax, vmax))
        planes.append(plane[:height, :width])
    if len(comps) == 1:
        return planes[0]
    if len(comps) != 3:
        raise NotImplementedError(f"JPEG with {len(comps)} components")
    return ycc_to_rgb(*planes)


def _upsample(plane, fx: int, fy: int, factors) -> np.ndarray:
    if (fx, fy) == (1, 1):
        return plane
    if (fx, fy) not in ((2, 1), (2, 2)) or any(
            f * c != m for f, c, m in ((fx, factors[0], factors[2]),
                                       (fy, factors[1], factors[3]))):
        raise NotImplementedError(f"JPEG chroma sampling {factors[0]}x"
                                  f"{factors[1]} of {factors[2]}x{factors[3]}")
    if plane.shape[1] <= 2:
        # jdsample.c replicates samples where the component is this narrow
        return np.repeat(np.repeat(plane, fx, axis=1), fy, axis=0)
    return _upsample_h2(plane) if fy == 1 else _upsample_h2v2(plane)


def read_jpeg(path) -> np.ndarray:
    """The pixels of the JPEG file at ``path``, as ``np.array(Image.open(
    path))`` gives them: [H, W] uint8 grey or [H, W, 3] uint8 RGB."""
    return decode_jpeg(Path(path).read_bytes())


def jpeg_size(path) -> tuple:
    """(width, height) of the JPEG file at ``path``, read from its frame
    header without decoding (as ``Image.open(path).size``)."""
    data = Path(path).read_bytes()
    pos = 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        pos += 2
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            height, width = struct.unpack(">HH", data[pos + 3:pos + 7])
            return width, height
        pos += length
    raise ValueError(f"{path}: no JPEG frame header")
