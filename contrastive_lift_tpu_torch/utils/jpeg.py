"""A JPEG decoder and a baseline JPEG encoder in numpy: the port's stand-in
for PIL's JPEG codec, which the card's machine does not have.

The decoder reads baseline, extended sequential and progressive Huffman
files (SOF0, SOF1, SOF2) of 8-bit precision with 1 component, or 3 YCbCr
components sampled 4:4:4, 4:2:2 or 4:2:0, of any size, with or without
restart intervals: what the repository's scene writer stores
(``data/preprocessing/common.py::SceneWriter``) and what users' frames
are. It follows libjpeg-turbo (API 6.2), which PIL decodes with, so that
its pixels are PIL's:

- progressive scans as ``jdphuff.c`` decodes them: DC first and refine
  scans, AC first scans with end-of-band runs, AC refine scans with
  correction bits (a file whose low-frequency AC bits are still unsent at
  the end, which libjpeg would block-smooth, raises instead);
- the "islow" integer inverse DCT of ``jidctint.c`` (13 constant bits,
  2 pass-1 bits) with its range-limiting table;
- the "fancy" triangle upsampling of ``jdsample.c`` for h2v1 and h2v2
  chroma (rounding biases 1/2 and 8/7), and plain replication where the
  chroma is at most 2 samples wide, as ``jdsample.c`` chooses;
- the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` (16 scale bits).

Lossless, hierarchical and arithmetic-coded files raise
``NotImplementedError`` naming the process. The Huffman decoding is a plain
Python loop (about 1 s for a 968x1296 quality-95 frame on one host core);
dequantisation, the IDCT, upsampling and colour conversion run in numpy.

``encode_jpeg`` writes, byte for byte, the baseline file PIL writes with
``save(f, "JPEG", quality=q)``: libjpeg-turbo's compressor with the JFIF
header, the Annex K tables scaled by ``jpeg_quality_scaling``, the
fixed-point RGB -> YCbCr of ``jccolor.c``, 4:2:0 chroma by
``jcsample.c``'s biased averages, the edge padding and dummy blocks of
``jcprepct.c`` and ``jccoefct.c``, the islow forward DCT of
``jfdctint.c``, the reciprocal quantisation of ``jcdctmgr.c`` and the
standard Huffman tables; the bits are packed in numpy (under a second for
a 968x1296 frame).
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
    0xC3: "lossless JPEG (SOF3)",
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
    """Decode a baseline, extended sequential or progressive Huffman JPEG
    byte string -> [H, W] uint8 (1 component) or [H, W, 3] uint8 RGB (3
    components, YCbCr)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    quant, dc_tables, ac_tables = {}, {}, {}
    frame, comps, restart, progressive = None, [], 0, False
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
        elif marker in (0xC0, 0xC1, 0xC2):
            precision, height, width, n = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise NotImplementedError(f"{precision}-bit JPEG precision")
            if height == 0:
                raise NotImplementedError("JPEG height given by a DNL marker")
            frame = (height, width)
            progressive = marker == 0xC2
            comps = [{"id": seg[6 + 3 * c], "h": seg[7 + 3 * c] >> 4,
                      "v": seg[7 + 3 * c] & 15, "tq": seg[8 + 3 * c]}
                     for c in range(n)]
            if progressive:
                for comp in comps:
                    _allocate(frame, comps, comp)
        elif marker == 0xDD:
            restart = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            pos = _read_scan(data, pos, seg, frame, comps, dc_tables,
                             ac_tables, restart, progressive)
        # APPn, COM and anything else with a length: skipped
    if frame is None:
        raise ValueError("JPEG: no frame header")
    if progressive:
        _refuse_block_smoothing(comps)
    return _reconstruct(frame, comps, quant)


def _geometry(frame, comps):
    """(hmax, vmax, MCUs across, MCUs down) of the frame."""
    height, width = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    return (hmax, vmax, -(-width // (8 * hmax)), -(-height // (8 * vmax)))


def _allocate(frame, comps, comp) -> None:
    """The component's coefficient store over the whole MCU grid, and the
    point transform each coefficient was last refined to (jdinput.c's
    ``coef_bits``: -1 until a scan sends it)."""
    _, _, mcux, mcuy = _geometry(frame, comps)
    comp["blocks"] = (mcuy * comp["v"], mcux * comp["h"])
    comp["store"] = array("i", bytes(4 * 64 * comp["blocks"][0]
                                     * comp["blocks"][1]))
    comp["coef_bits"] = [-1] * 64


# libjpeg-turbo's jdcoefct.c::SAVED_COEFS: block smoothing looks at the DC
# and the first 9 AC coefficients (zig-zag order)
_SMOOTHED_COEFS = 10


def _refuse_block_smoothing(comps) -> None:
    """jdcoefct.c::smoothing_ok: libjpeg smooths the blocks of a progressive
    file whose low-frequency AC coefficients are still unsent or unrefined
    at output time (every component's DC seen). The port does not, so it
    refuses such a file rather than give other pixels."""
    bits = [c["coef_bits"] for c in comps]
    if all(b[0] >= 0 for b in bits) and any(
            b[k] != 0 for b in bits for k in range(1, _SMOOTHED_COEFS)):
        raise NotImplementedError(
            "progressive JPEG with incomplete low-frequency AC coefficients "
            "(libjpeg's block smoothing)")


def _read_scan(data, pos, header, frame, comps, dc_tables, ac_tables,
               restart, progressive) -> int:
    """Decode the scan whose SOS header is ``header`` into the components'
    coefficient stores; returns the offset of the marker after the scan."""
    height, width = frame
    hmax, vmax, mcux, mcuy = _geometry(frame, comps)
    n = header[0]
    by_id = {c["id"]: (i, c) for i, c in enumerate(comps)}
    ss, se = header[1 + 2 * n], header[2 + 2 * n]
    ah, al = header[3 + 2 * n] >> 4, header[3 + 2 * n] & 15
    if not progressive and (ss != 0 or se != 63):
        raise ValueError("JPEG: spectral selection in a sequential scan")
    if progressive and (se > 63 or ss > se or (ss == 0) != (se == 0)
                        or (ss > 0 and n != 1)):
        raise ValueError(f"JPEG: bad progressive scan Ss={ss} Se={se} "
                         f"with {n} components")
    scan = []
    for k in range(n):
        ci, comp = by_id[header[1 + 2 * k]]
        td, ta = header[2 + 2 * k] >> 4, header[2 + 2 * k] & 15
        # a scan reads only the tables it uses
        dc = dc_tables.get(td) if ss == 0 and ah == 0 else None
        ac = ac_tables.get(ta) if se > 0 and (ah == 0 or progressive) else None
        if (ss == 0 and ah == 0 and dc is None) or (se > 0 and ac is None):
            raise ValueError("JPEG: scan uses an undefined Huffman table")
        scan.append((ci, comp, dc, ac))
    for ci, comp, _, _ in scan:
        if "store" not in comp:
            _allocate(frame, comps, comp)
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
    if progressive:
        _decode_progressive(segments, offsets, blocks, restart,
                            ss, se, ah, al)
        for _, comp, _, _ in scan:
            comp["coef_bits"][ss:se + 1] = [al] * (se + 1 - ss)
    else:
        _decode_scan(segments, offsets, blocks, restart)
    return end


def _decode_progressive(segments, offsets, blocks, restart, ss, se, ah, al):
    """Huffman-decode one progressive scan (jdphuff.c): DC first or refine
    (``ss`` 0), AC first with end-of-band runs, or AC refine with
    correction bits, over the coefficient bits ``al`` (``ah`` 0 for a first
    scan). Arguments as ``_decode_scan``'s."""
    natural = NATURAL_ORDER.tolist()
    n_comp = max(b[3] for b in blocks) + 1
    preds = [0] * n_comp
    seg_bounds, data = [], bytearray()
    for seg in segments:
        seg_bounds.append(len(data) * 8)
        data += seg
    win = _windows(bytes(data))
    seg_index, pos, eobrun = 0, 0, 0
    p1, m1 = 1 << al, -1 << al

    def symbol(table):
        nonlocal pos
        top = win[pos] >> 16
        length = table.length[top]
        if not length:
            raise ValueError("corrupt JPEG data: bad Huffman code")
        pos += length
        return table.symbol[top]

    def bits(s):
        nonlocal pos
        r = win[pos] >> (32 - s)
        pos += s
        return r

    def extend(s):
        r = bits(s)
        return r + 1 - (1 << s) if r < (1 << (s - 1)) else r

    def correct(store, at):
        """A correction bit for an already-nonzero coefficient."""
        nonlocal pos
        bit = win[pos] >> 31
        pos += 1
        if bit and not store[at] & p1:
            store[at] += p1 if store[at] >= 0 else m1

    for m in range(len(offsets)):
        if restart and m and m % restart == 0:
            seg_index += 1
            if seg_index >= len(seg_bounds):
                raise ValueError("JPEG scan ends before its last restart "
                                 "interval")
            pos = seg_bounds[seg_index]
            preds = [0] * n_comp
            eobrun = 0
        for (store, dc, ac, ci), off in zip(blocks, offsets[m]):
            base = off * 64
            if ss == 0:
                if ah == 0:
                    s = symbol(dc)
                    if s:
                        preds[ci] += extend(s)
                    store[base] = preds[ci] << al
                else:
                    bit = win[pos] >> 31
                    pos += 1
                    if bit:
                        store[base] |= p1
            elif ah == 0:
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = symbol(ac)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        if k > 63:
                            raise ValueError("corrupt JPEG data: "
                                             "coefficient index past 63")
                        store[base + natural[k]] = extend(s) << al
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + (bits(r) if r else 0) - 1
                        break
                    k += 1
            else:
                k = ss
                if eobrun == 0:
                    while k <= se:
                        rs = symbol(ac)
                        r, s = rs >> 4, rs & 15
                        if s:
                            bit = win[pos] >> 31
                            pos += 1
                            s = p1 if bit else m1
                        elif r != 15:
                            eobrun = (1 << r) + (bits(r) if r else 0)
                            break
                        # skip r still-zero coefficients, correcting the
                        # nonzero ones on the way
                        while k <= se:
                            at = base + natural[k]
                            if store[at]:
                                correct(store, at)
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            if k > 63:
                                raise ValueError("corrupt JPEG data: "
                                                 "coefficient index past 63")
                            store[base + natural[k]] = s
                        k += 1
                if eobrun > 0:
                    while k <= se:
                        at = base + natural[k]
                        if store[at]:
                            correct(store, at)
                        k += 1
                    eobrun -= 1


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


# ---------------------------------------------------------------------------
# Baseline encoder (libjpeg-turbo's compressor, as PIL drives it)
# ---------------------------------------------------------------------------

# jcparam.c: the Annex K quantisation tables, natural order
_STD_QUANT = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
             + [99] * 32))


def _std_ac_symbols(head):
    """jstdhuff.c's AC symbol list: the symbols of the short codes as the
    standard lists them, then every other symbol in increasing order."""
    every = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                            for s in range(1, 11)]
    return list(head) + sorted(set(every) - set(head))


# jstdhuff.c: (code counts by length 1..16, symbols) of DC and AC tables 0
# (luminance) and 1 (chrominance)
_STD_HUFFMAN = {
    ("dc", 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                list(range(12))),
    ("dc", 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                list(range(12))),
    ("ac", 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
                _std_ac_symbols([
                    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21,
                    0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
                    0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1,
                    0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
                    0x82])),
    ("ac", 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
                _std_ac_symbols([
                    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31,
                    0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
                    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1,
                    0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
                    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1])),
}


def _code_table(counts, symbols):
    """jchuff.c::jpeg_make_c_derived_tbl: canonical codes -> (code [256],
    length [256]) indexed by symbol (length 0: no code)."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for bits in range(1, 17):
        for _ in range(counts[bits - 1]):
            code_of[symbols[k]], len_of[symbols[k]] = code, bits
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def quant_tables(quality: int):
    """jcparam.c::jpeg_set_quality(quality, force_baseline=TRUE): the
    luminance and chrominance tables, natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return tuple(np.clip((base * scale + 50) // 100, 1, 255) for base in
                 _STD_QUANT)


def _fix16(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c::rgb_ycc_convert: 16 scale bits, Cb and Cr rounded by
    ONE_HALF - 1 so that they never reach 256."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    offset = (128 << 16) + half - 1
    y = (_fix16(0.299) * r + _fix16(0.587) * g + _fix16(0.114) * b
         + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
          + offset) >> 16
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
          + offset) >> 16
    return y, cb, cr


def _pad_edge(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Replicate the last row and column out to ``rows`` x ``cols``
    (jcsample.c::expand_right_edge, jcprepct.c::expand_bottom_edge)."""
    return np.pad(plane, ((0, rows - plane.shape[0]),
                          (0, cols - plane.shape[1])), mode="edge")


def _fdct_1d(x, descale_even, descale_odd, dc_shift):
    """One pass of jfdctint.c::jpeg_fdct_islow over x[0..7]."""
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    out[0], out[4] = dc_shift(tmp10 + tmp11), dc_shift(tmp10 - tmp11)
    z1 = (tmp12 + tmp13) * _FIX_0_541196100
    out[2] = descale_even(z1 + tmp13 * _FIX_0_765366865)
    out[6] = descale_even(z1 + tmp12 * -_FIX_1_847759065)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _FIX_1_175875602
    tmp4 = tmp4 * _FIX_0_298631336
    tmp5 = tmp5 * _FIX_2_053119869
    tmp6 = tmp6 * _FIX_3_072711026
    tmp7 = tmp7 * _FIX_1_501321110
    z1 = z1 * -_FIX_0_899976223
    z2 = z2 * -_FIX_2_562915447
    z3 = z3 * -_FIX_1_961570560 + z5
    z4 = z4 * -_FIX_0_390180644 + z5
    out[7] = descale_odd(tmp4 + z1 + z3)
    out[5] = descale_odd(tmp5 + z2 + z4)
    out[3] = descale_odd(tmp6 + z2 + z3)
    out[1] = descale_odd(tmp7 + z1 + z4)
    return out


def _descale(n):
    return lambda v: (v + (1 << (n - 1))) >> n


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jfdctint.c::jpeg_fdct_islow of [N, 8, 8] samples (already shifted by
    -128) -> [N, 8, 8] coefficients scaled up by 8, natural order."""
    x = blocks.astype(np.int64)
    d1 = _descale(_CONST_BITS - _PASS1_BITS)
    ws = np.stack(_fdct_1d([x[:, :, k] for k in range(8)], d1, d1,
                           lambda v: v << _PASS1_BITS), axis=2)
    d2 = _descale(_CONST_BITS + _PASS1_BITS)
    return np.stack(_fdct_1d([ws[:, k, :] for k in range(8)], d2, d2,
                             _descale(_PASS1_BITS)), axis=1)


def _reciprocals(divisor: np.ndarray):
    """jcdctmgr.c::compute_reciprocal for 16-bit DCT elements (the SIMD
    build): (reciprocal, correction, shift) so that |x| / divisor, rounded,
    is ((|x| + correction) * reciprocal) >> shift."""
    fq, corr, shift = [], [], []
    for d in divisor.tolist():
        b = d.bit_length() - 1
        r = 16 + b
        q, rem = divmod(1 << r, d)
        c = d // 2
        if rem == 0:
            q, r = q >> 1, r - 1
        elif rem <= d // 2:
            c += 1
        else:
            q += 1
        fq.append(q)
        corr.append(c)
        shift.append(r)
    return (np.array(fq, np.int64), np.array(corr, np.int64),
            np.array(shift, np.int64))


def quantize(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """jcdctmgr.c::quantize (the reciprocal form libjpeg-turbo uses) of
    [N, 64] natural-order coefficients by a natural-order table."""
    fq, corr, shift = _reciprocals(quant.astype(np.int64) << 3)
    mag = ((np.abs(coefs) + corr) * fq) >> shift
    return np.where(coefs < 0, -mag, mag)


def _nbits(v: np.ndarray) -> np.ndarray:
    """The magnitude category of each value: bits of |v| (0 for 0)."""
    mag = np.abs(v)
    return np.where(mag > 0, np.floor(np.log2(np.maximum(mag, 1))) + 1,
                    0).astype(np.int64)


def _huffman_events(zz: np.ndarray, dc_diff: np.ndarray, table: np.ndarray):
    """The bit strings of the blocks ``zz`` [N, 64] (zig-zag order) as
    (value, length) per slot [N, 65]: slot 0 the DC difference, slot k the
    AC coefficient k with the ZRLs that precede it, slot 64 the EOB
    (jchuff.c::encode_one_block); ``table`` [N] picks the tables of each
    block (0 luminance, 1 chrominance)."""
    codes = {key: _code_table(*spec) for key, spec in _STD_HUFFMAN.items()}
    dc_code = np.stack([codes["dc", t][0] for t in (0, 1)])
    dc_len = np.stack([codes["dc", t][1] for t in (0, 1)])
    ac_code = np.stack([codes["ac", t][0] for t in (0, 1)])
    ac_len = np.stack([codes["ac", t][1] for t in (0, 1)])
    # 0-3 ZRL codes in a row (a run of up to 62 zeros)
    zrl_len = ac_len[:, 0xF0, None] * np.arange(4)
    zrl_val = np.zeros((2, 4), np.int64)
    for z in range(1, 4):
        zrl_val[:, z] = (zrl_val[:, z - 1] << ac_len[:, 0xF0]) | ac_code[:, 0xF0]
    t = table[:, None]

    def value_bits(v, s):
        return np.where(v < 0, v + (1 << s) - 1, v)

    n = len(zz)
    vals = np.zeros((n, 65), np.int64)
    lens = np.zeros((n, 65), np.int64)
    s = _nbits(dc_diff)
    vals[:, 0] = (dc_code[table, s] << s) | value_bits(dc_diff, s)
    lens[:, 0] = dc_len[table, s] + s
    ac = zz[:, 1:].astype(np.int64)
    nz = ac != 0
    pos = np.arange(1, 64)
    seen = np.maximum.accumulate(np.where(nz, pos, 0), axis=1)
    prev = np.concatenate([np.zeros((n, 1), np.int64), seen[:, :-1]], axis=1)
    run = pos - prev - 1
    z, r = run >> 4, run & 15
    s = _nbits(ac)
    sym = (r << 4) | s
    cl = ac_len[t, sym]
    v = (((zrl_val[t, z] << cl) | ac_code[t, sym]) << s) | value_bits(ac, s)
    vals[:, 1:64] = np.where(nz, v, 0)
    lens[:, 1:64] = np.where(nz, zrl_len[t, z] + cl + s, 0)
    eob = seen[:, -1] < 63
    vals[:, 64] = np.where(eob, ac_code[table, 0], 0)
    lens[:, 64] = np.where(eob, ac_len[table, 0], 0)
    return vals.reshape(-1), lens.reshape(-1)


def _pack_bits(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate the bit strings, pad the last byte with 1-bits
    (jchuff.c::flush_bits) and stuff a zero after every 0xFF byte."""
    keep = lens > 0
    vals, lens = vals[keep], lens[keep]
    pad = -int(lens.sum()) % 8
    if pad:
        vals = np.append(vals, (1 << pad) - 1)
        lens = np.append(lens, pad)
    owner = np.repeat(np.arange(len(lens)), lens)
    start = np.cumsum(lens) - lens
    j = np.arange(int(lens.sum())) - start[owner]
    bits = (vals[owner] >> (lens[owner] - 1 - j)) & 1
    data = np.packbits(bits.astype(np.uint8))
    ff = data == 0xFF
    out = np.repeat(data, 1 + ff)
    out[np.flatnonzero(ff) + np.arange(1, int(ff.sum()) + 1)] = 0
    return out.tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _component_blocks(plane, h, v, hmax, vmax, width, height, mcux, mcuy):
    """One component's quantisable blocks laid out over the MCU grid:
    the samples padded as jcprepct.c and jcsample.c pad them, and the
    block grid [mcuy * v, mcux * h] with the dummy blocks
    jccoefct.c::compress_data adds marked (returned as the real block
    counts across and down)."""
    wib = -(-width * h // (hmax * 8))
    hib = -(-height * v // (vmax * 8))
    rows = -(-height // vmax) * vmax
    if h == hmax:
        plane = _pad_edge(plane, rows, wib * 8)
    else:
        # jcsample.c::h2v2_downsample: biased 2x2 averages, bias 1, 2, 1, ...
        p = _pad_edge(plane, rows, wib * 16)
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        bias = np.tile([1, 2], wib * 4)
        plane = (s + bias) >> 2
    return _pad_edge(plane, mcuy * v * 8, plane.shape[1]), wib, hib


def encode_jpeg(image: np.ndarray, quality: int = 75) -> bytes:
    """The baseline JPEG that ``Image.fromarray(image).save(f, "JPEG",
    quality=quality)`` writes, byte for byte: [H, W, 3] uint8 RGB as YCbCr
    4:2:0, or [H, W] uint8 grey; quality 1..100."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (
            image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes [H, W] or [H, W, 3] uint8, got "
                         f"{image.shape} {image.dtype}")
    height, width = image.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"JPEG size out of range: {width}x{height}")
    tables = quant_tables(quality)
    if image.ndim == 2:
        planes = [image.astype(np.int64)]
        comps = [(1, 1, 1, 0)]            # (id, h, v, table)
    else:
        planes = list(rgb_to_ycc(image))
        comps = [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    grids, kinds = [], []
    for plane, (_, h, v, tq) in zip(planes, comps):
        padded, wib, hib = _component_blocks(plane, h, v, hmax, vmax, width,
                                             height, mcux, mcuy)
        blocks = padded[:hib * 8, :wib * 8] - 128
        blocks = blocks.reshape(hib, 8, wib, 8).transpose(0, 2, 1, 3)
        coefs = quantize(fdct_islow(blocks.reshape(-1, 8, 8)).reshape(-1, 64),
                         tables[tq]).reshape(hib, wib, 64)
        if len(comps) == 1:
            grid = coefs
        else:
            # jccoefct.c: dummy blocks have zero AC and the DC of the block
            # before them in the MCU (right edge: the last real block of the
            # row; bottom: the last block of the row above)
            grid = np.zeros((mcuy * v, mcux * h, 64), np.int64)
            grid[:hib, :wib] = coefs
            grid[:hib, wib:, 0] = coefs[:, -1:, 0]
            for r in range(hib, mcuy * v):
                grid[r, :, 0] = np.repeat(grid[r - 1, h - 1::h, 0], h)
            grid = grid.reshape(mcuy, v, mcux, h, 64).transpose(0, 2, 1, 3, 4)
            grid = grid.reshape(mcuy * mcux, v * h, 64)
        grids.append(grid.reshape(len(grid), -1, 64))
        kinds.append(np.full(grids[-1].shape[1], len(kinds)))
    blocks = np.concatenate(grids, axis=1).reshape(-1, 64)
    comp_of = np.tile(np.concatenate(kinds), len(grids[0]))
    dc_diff = np.zeros(len(blocks), np.int64)
    for ci in range(len(comps)):
        sel = comp_of == ci
        dc_diff[sel] = np.diff(blocks[sel, 0], prepend=0)
    table = np.array([c[3] for c in comps])[comp_of]
    zz = blocks[:, NATURAL_ORDER]
    entropy = _pack_bits(*_huffman_events(zz, dc_diff, table))

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00"
                                         b"\x01\x00\x00")]
    for tq in sorted({c[3] for c in comps}):
        out.append(_segment(0xDB, bytes([tq]) + bytes(
            tables[tq][NATURAL_ORDER].astype(np.uint8))))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, height, width,
                                          len(comps)) + b"".join(
        bytes([cid, (h << 4) | v, tq]) for cid, h, v, tq in comps)))
    for tq in sorted({c[3] for c in comps}):
        for cls, kind in ((0, "dc"), (1, "ac")):
            counts, symbols = _STD_HUFFMAN[kind, tq]
            out.append(_segment(0xC4, bytes([(cls << 4) | tq]) + bytes(counts)
                                + bytes(symbols)))
    out.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([cid, (tq << 4) | tq]) for cid, _, _, tq in comps)
        + b"\x00\x3f\x00"))
    out += [entropy, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path, image: np.ndarray, quality: int = 75) -> Path:
    """``encode_jpeg(image, quality)`` written to ``path``."""
    path = Path(path)
    path.write_bytes(encode_jpeg(image, quality))
    return path
