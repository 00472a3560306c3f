"""A JPEG decoder and a baseline JPEG encoder in numpy: the port's stand-in
for PIL's JPEG codec, which the card's machine does not have.

The decoder reads the JPEG files PIL reads, with the pixels PIL gives
(``np.asarray(Image.open(f))``). PIL decodes with libjpeg-turbo (3.1, API
6.2), and the decoder follows it:

- processes: baseline and extended sequential (SOF0, SOF1), progressive
  (SOF2) and lossless (SOF3) Huffman files, and sequential (SOF9) and
  progressive (SOF10) arithmetic-coded files with their DAC conditioning,
  of 8-bit precision and any size, with or without restart intervals;
- progressive scans as ``jdphuff.c`` and ``jdarith.c`` decode them (DC
  first and refine scans, AC first scans with end-of-band runs, AC refine
  scans), and ``jdcoefct.c::decompress_smooth_data``'s block smoothing of
  files whose low-frequency AC bits are incomplete at the end;
- the arithmetic decoder of ``jdarith.c`` (the Q-coder and the state table
  of ITU-T T.81 Table D.2, the DC and AC statistics and their
  conditioning, statistics reset at each restart);
- lossless scans as ``jdlhuff.c``, ``jddiffct.c`` and ``jdlossls.c`` decode
  them: predictors 1-7, the point transform, the first row of the scan
  and of each restart interval predicted from 2^(P-Pt-1);
- the "islow" integer inverse DCT of ``jidctint.c`` (13 constant bits,
  2 pass-1 bits) with its range-limiting table;
- the upsampling of ``jdsample.c`` for any integral sampling ratio: the
  "fancy" triangles for h2v1, h1v2 and h2v2 (plain replication where h2
  chroma is at most 2 samples wide, and in lossless files), replication
  for the other ratios (4:1:1, h4v2, h1v4, ...);
- the colour space of ``jdapimin.c::default_decompress_parms``, read from
  the JFIF (APP0) and Adobe (APP14) markers and the component ids: 1
  component is grey; 3 are YCbCr (through the fixed-point tables of
  ``jdcolor.c``, 16 scale bits) or RGB (copied); 4 are CMYK or YCCK,
  given as PIL gives mode CMYK (Adobe-inverted: 255 - the samples; YCCK as
  ``ycck_cmyk_convert``'s output, inverted).

``decode_jpeg`` returns [H, W] uint8 (grey), [H, W, 3] (RGB) or [H, W, 4]
(CMYK, whose mode ``jpeg_mode`` names: PIL resizes and greys it otherwise
than RGBA). Hierarchical files (SOF5-SOF7, SOF13-SOF15), arithmetic-coded
lossless files (SOF11), precisions other than 8 bits and heights given by a
DNL marker raise ``NotImplementedError`` naming what they are; PIL refuses
them all. The Huffman and arithmetic decoding are plain Python loops
(about 1 s for a 968x1296 quality-95 Huffman frame on one host core);
dequantisation, smoothing, the IDCT, upsampling and colour conversion run
in numpy.

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
# the frame headers the decoder reads: (entropy coding, process)
_SOF = {0xC0: ("huffman", "sequential"), 0xC1: ("huffman", "sequential"),
        0xC2: ("huffman", "progressive"), 0xC3: ("huffman", "lossless"),
        0xC9: ("arithmetic", "sequential"),
        0xCA: ("arithmetic", "progressive")}
# ... and those libjpeg-turbo refuses as PIL drives it
_REFUSED_SOF = {
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "hierarchical arithmetic-coded JPEG (SOF13)",
    0xCE: "hierarchical arithmetic-coded JPEG (SOF14)",
    0xCF: "hierarchical arithmetic-coded JPEG (SOF15)"}

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


def _upsample_v2(plane: np.ndarray) -> np.ndarray:
    """jdsample.c::h1v2_fancy_upsample on [h, w] samples -> [2h, w], with
    the rows above the first and below the last replicated (jdmainct.c)."""
    p = plane.astype(np.int32)
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
    out[0::2] = (3 * p + above + 1) >> 2
    out[1::2] = (3 * p + below + 2) >> 2
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


def _upsample(plane, h: int, v: int, hmax: int, vmax: int,
              fancy: bool) -> np.ndarray:
    """jdsample.c::jinit_upsampler's choice for a component sampled h x v
    of hmax x vmax: the fancy triangles where ``fancy`` (not in lossless
    files, whose DCT size is 1) and the ratio is 2 across (the component
    more than 2 samples wide), 2 down, or both (as wide), else integral
    replication (``h2v1_upsample``, ``h2v2_upsample``, ``int_upsample``).
    Non-integral ratios raise, as libjpeg does."""
    if (h, v) == (hmax, vmax):
        return plane
    if hmax % h or vmax % v:
        raise NotImplementedError(f"JPEG chroma sampling {h}x{v} of "
                                  f"{hmax}x{vmax}")
    fx, fy = hmax // h, vmax // v
    if fancy:
        if fx == 1 and fy == 2:
            return _upsample_v2(plane)
        if fx == 2 and fy in (1, 2) and plane.shape[1] > 2:
            return _upsample_h2(plane) if fy == 1 else _upsample_h2v2(plane)
    return np.repeat(np.repeat(plane, fx, axis=1), fy, axis=0)


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


def _colour_space(ids, jfif: bool, adobe, lossless: bool) -> str:
    """jdapimin.c::default_decompress_parms: the colour space of a frame
    with component ``ids`` from the markers seen before its first scan
    (``adobe``: the Adobe transform, None without the marker)."""
    if len(ids) == 1:
        return "L"
    if len(ids) == 3:
        if jfif:
            return "YCbCr"
        if adobe is not None:
            return "RGB" if adobe == 0 else "YCbCr"
        if tuple(ids) == (82, 71, 66):          # 'R', 'G', 'B'
            return "RGB"
        # ids 1, 2, 3 and any others: YCbCr, but RGB in a lossless file
        return "RGB" if lossless else "YCbCr"
    if len(ids) == 4:
        return "YCCK" if adobe not in (None, 0) else "CMYK"
    raise NotImplementedError(f"JPEG with {len(ids)} components")


def _pixels(planes, space: str) -> np.ndarray:
    """The output PIL gives for full-size planes in ``space``: grey, RGB,
    or CMYK through libjpeg's CMYK output and PIL's ``CMYK;I`` raw mode,
    which inverts every channel."""
    if space == "L":
        return planes[0]
    if space == "YCbCr":
        return ycc_to_rgb(*planes)
    if space == "RGB":
        return np.stack(planes, axis=-1)
    if space == "CMYK":
        return 255 - np.stack(planes, axis=-1)
    # jdcolor.c::ycck_cmyk_convert gives 255 - R, G, B (clamped) and K as
    # it is; PIL inverts all four
    return np.concatenate([ycc_to_rgb(*planes[:3]), 255 - planes[3][..., None]],
                          axis=-1)


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


def _joined(segments):
    """The segments as one bit stream: (bit offset of each segment,
    ``_windows`` of their concatenation)."""
    bounds, data = [], bytearray()
    for seg in segments:
        bounds.append(len(data) * 8)
        data += seg
    return bounds, _windows(bytes(data))


def _next_segment(bounds, index: int) -> int:
    if index >= len(bounds):
        raise ValueError("JPEG scan ends before its last restart interval")
    return bounds[index]


def _decode_scan(segments, offsets, blocks, restart: int):
    """Huffman-decode one sequential scan into the components' coefficient
    stores, in natural order. ``blocks`` lists the blocks of an MCU as
    (coefficient store, DC table, AC table, index of the component in the
    scan), and ``offsets[m]`` the block index in its store of each of MCU
    m's blocks. ``restart`` is the restart interval in MCUs (0: none)."""
    natural = NATURAL_ORDER.tolist()
    n_comp = max(b[3] for b in blocks) + 1
    preds = [0] * n_comp
    seg_bounds, win = _joined(segments)
    seg_index, pos = 0, 0
    for m in range(len(offsets)):
        if restart and m and m % restart == 0:
            seg_index += 1
            pos = _next_segment(seg_bounds, seg_index)
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


def _decode_progressive(segments, offsets, blocks, restart, ss, se, ah, al):
    """Huffman-decode one progressive scan (jdphuff.c): DC first or refine
    (``ss`` 0), AC first with end-of-band runs, or AC refine with
    correction bits, over the coefficient bits ``al`` (``ah`` 0 for a first
    scan). Arguments as ``_decode_scan``'s."""
    natural = NATURAL_ORDER.tolist()
    n_comp = max(b[3] for b in blocks) + 1
    preds = [0] * n_comp
    seg_bounds, win = _joined(segments)
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
            pos = _next_segment(seg_bounds, seg_index)
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


# ---------------------------------------------------------------------------
# Arithmetic decoding (jdarith.c)
# ---------------------------------------------------------------------------

# ITU-T T.81 Table D.2, (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS)
# for states 0-112, and state 113: the fixed probability 0.5 (T.851) that
# the AC signs and the refinement bits use
_QE_TABLE = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0),
    (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0),
    (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0CEF, 43, 21, 0),
    (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0),
    (0x2EF1, 67, 40, 0), (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0),
    (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0),
    (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0),
    (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0),
    (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0),
    (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0),
    (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0),
    (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0),
    (0x3C3D, 104, 100, 0), (0x375E, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1),
    (0x5A1D, 113, 113, 0)]
# ... packed as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
# Switch_MPS << 7 | Next_Index_LPS
ARITH_TABLE = [(qe << 16) | (nmps << 8) | (switch << 7) | nlps
               for qe, nlps, nmps, switch in _QE_TABLE]
_FIXED_STATE = 113
# jdarith.c: statistics bins of a DC and an AC conditioning table
_DC_STAT_BINS, _AC_STAT_BINS = 64, 256


def _arith_decoder(segment: bytes):
    """jdarith.c::arith_decode over one entropy-coded segment (zeros past
    its end, as libjpeg supplies once it meets a marker): returns
    ``decode(stats, i)``, the next decision in statistics bin
    ``stats[i]`` (a bytearray of states with the MPS in bit 7), which it
    updates."""
    table = ARITH_TABLE
    n = len(segment)
    pos, c, a, ct = 0, 0, 0, -16      # ct -16: read 2 bytes to fill C

    def decode(st, i):
        nonlocal pos, c, a, ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                c = (c << 8) | (segment[pos] if pos < n else 0)
                pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000     # 2 initial bytes: A = 0x10000 below
            a <<= 1
        sv = st[i]
        q = table[sv & 0x7F]
        qe = q >> 16
        temp = a - qe
        a = temp
        temp <<= ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[i] = (sv & 0x80) ^ ((q >> 8) & 0xFF)     # after an MPS
            else:
                a = qe
                st[i] = (sv & 0x80) ^ (q & 0xFF)            # after an LPS
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ (q & 0xFF)
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ ((q >> 8) & 0xFF)
        return sv >> 7

    return decode


def _short(v: int) -> int:
    """The JCOEF (int16) libjpeg stores for ``v``."""
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


def _decode_arith(segments, offsets, blocks, restart, conditioning,
                  progressive, ss, se, ah, al):
    """Arithmetic-decode one scan (jdarith.c: ``decode_mcu`` for a
    sequential scan, ``decode_mcu_DC_first``, ``decode_mcu_AC_first``,
    ``decode_mcu_DC_refine`` and ``decode_mcu_AC_refine`` for a
    progressive one). ``blocks`` and ``offsets`` as ``_decode_scan``'s,
    the tables in ``blocks`` being conditioning table numbers;
    ``conditioning`` holds the DAC values ({"dc": {t: (L, U)}, "ac": {t:
    K}}, defaults L 0, U 1, K 5). The statistics are reset at the start
    and at each restart."""
    natural = NATURAL_ORDER.tolist()
    n_comp = max(b[3] for b in blocks) + 1
    dc_first = not progressive or (ss == 0 and ah == 0)
    uses_ac = not progressive or ss > 0
    dc_tbls = sorted({b[1] for b in blocks}) if dc_first else []
    ac_tbls = sorted({b[2] for b in blocks}) if uses_ac else []
    dc_cond = {t: conditioning["dc"].get(t, (0, 1)) for t in dc_tbls}
    ac_k = {t: conditioning["ac"].get(t, 5) for t in ac_tbls}
    last_k = 63 if not progressive else se
    first_k = 1 if not progressive else ss
    p1, m1 = 1 << al, -1 << al
    fixed = bytearray([_FIXED_STATE])
    seg_index = 0

    def reset():
        stats = ({t: bytearray(_DC_STAT_BINS) for t in dc_tbls},
                 {t: bytearray(_AC_STAT_BINS) for t in ac_tbls})
        return stats, [0] * n_comp, [0] * n_comp

    decode = _arith_decoder(segments[0])
    (dc_stats, ac_stats), last_dc, dc_context = reset()

    def dc_diff(st, ci, tbl):
        """Figures F.19-F.24: the next DC difference of component ``ci``."""
        base = dc_context[ci]
        if not decode(st, base):
            dc_context[ci] = 0
            return 0
        sign = decode(st, base + 1)
        k = base + 2 + sign
        m = decode(st, k)
        if m:
            k = 20
            while decode(st, k):
                m <<= 1
                if m == 0x8000:
                    raise ValueError("corrupt JPEG data: arithmetic "
                                     "magnitude overflow")
                k += 1
        lo, hi = dc_cond[tbl]
        if m < (1 << lo) >> 1:
            dc_context[ci] = 0
        elif m > (1 << hi) >> 1:
            dc_context[ci] = 12 + sign * 4
        else:
            dc_context[ci] = 4 + sign * 4
        v = m
        k += 14
        m >>= 1
        while m:
            if decode(st, k):
                v |= m
            m >>= 1
        v += 1
        return -v if sign else v

    def ac_value(st, k, s, kx):
        """Figures F.21-F.24 for an AC coefficient at zig-zag ``k`` whose
        statistics start at bin ``s``: the coefficient."""
        sign = decode(fixed, 0)
        s += 2
        m = decode(st, s)
        if m and decode(st, s):
            m <<= 1
            s = 189 if k <= kx else 217
            while decode(st, s):
                m <<= 1
                if m == 0x8000:
                    raise ValueError("corrupt JPEG data: arithmetic "
                                     "magnitude overflow")
                s += 1
        v = m
        s += 14
        m >>= 1
        while m:
            if decode(st, s):
                v |= m
            m >>= 1
        v += 1
        return -v if sign else v

    for m in range(len(offsets)):
        if restart and m and m % restart == 0:
            seg_index += 1
            if seg_index >= len(segments):
                raise ValueError("JPEG scan ends before its last restart "
                                 "interval")
            decode = _arith_decoder(segments[seg_index])
            (dc_stats, ac_stats), last_dc, dc_context = reset()
        for (store, td, ta, ci), off in zip(blocks, offsets[m]):
            base = off * 64
            if dc_first and ss == 0:
                last_dc[ci] = (last_dc[ci] + dc_diff(dc_stats[td], ci, td)) \
                    & 0xFFFF
                store[base] = _short(last_dc[ci] << al)
            elif ss == 0:
                if decode(fixed, 0):
                    store[base] |= p1
            if not uses_ac:
                continue
            st, kx = ac_stats[ta], ac_k[ta]
            if progressive and ah:
                # AC refine: the previous stage's end of block first
                kex = se
                while kex > 0 and not store[base + natural[kex]]:
                    kex -= 1
                k = ss
                while k <= se:
                    s = 3 * (k - 1)
                    if k > kex and decode(st, s):
                        break
                    while True:
                        at = base + natural[k]
                        if store[at]:
                            if decode(st, s + 2):
                                store[at] += m1 if store[at] < 0 else p1
                            break
                        if decode(st, s + 1):
                            store[at] = m1 if decode(fixed, 0) else p1
                            break
                        s += 3
                        k += 1
                        if k > se:
                            raise ValueError("corrupt JPEG data: "
                                             "arithmetic spectral overflow")
                    k += 1
                continue
            k = first_k
            while k <= last_k:
                s = 3 * (k - 1)
                if decode(st, s):
                    break                      # end of block
                while not decode(st, s + 1):
                    s += 3
                    k += 1
                    if k > last_k:
                        raise ValueError("corrupt JPEG data: arithmetic "
                                         "spectral overflow")
                v = ac_value(st, k, s, kx)
                store[base + natural[k]] = _short(v << al)
                k += 1


# ---------------------------------------------------------------------------
# Lossless decoding (jdlhuff.c, jddiffct.c, jdlossls.c)
# ---------------------------------------------------------------------------

def _decode_differences(segments, tables, n_mcu: int, restart: int):
    """jdlhuff.c::decode_mcus over a lossless scan: the sample differences
    of its ``n_mcu`` MCUs in order, ``tables`` giving the Huffman table of
    each sample of an MCU (category 16 is 32768 with no extra bits)."""
    seg_bounds, win = _joined(segments)
    out = array("i", bytes(4 * n_mcu * len(tables)))
    seg_index, pos, i = 0, 0, 0
    lengths = [t.length for t in tables]
    symbols = [t.symbol for t in tables]
    for m in range(n_mcu):
        if restart and m and m % restart == 0:
            seg_index += 1
            pos = _next_segment(seg_bounds, seg_index)
        for length, symbol in zip(lengths, symbols):
            top = win[pos] >> 16
            n = length[top]
            if not n:
                raise ValueError("corrupt JPEG data: bad Huffman code")
            s = symbol[top]
            pos += n
            if s:
                if s == 16:
                    out[i] = 32768
                elif s > 16:
                    raise ValueError("corrupt JPEG data: lossless "
                                     f"category {s}")
                else:
                    r = win[pos] >> (32 - s)
                    pos += s
                    out[i] = r if r >= 1 << (s - 1) else r + 1 - (1 << s)
            i += 1
    return out


def _undifference(diff: np.ndarray, psv: int, initial: int,
                  first_rows) -> np.ndarray:
    """jdlossls.c: samples from the differences [h, w] of one component,
    modulo 2^16. Rows in ``first_rows`` are predicted from ``initial``
    then from the left (``jpeg_undifference_first_row``); the others take
    the row above for their first sample and predictor ``psv`` (1 Ra,
    2 Rb, 3 Rc, 4 Ra + Rb - Rc, 5 Ra + ((Rb - Rc) >> 1), 6 Rb + ((Ra - Rc)
    >> 1), 7 (Ra + Rb) >> 1) for the rest."""
    mask = 0xFFFF
    d = diff.astype(np.int64)
    h, w = d.shape
    out = np.empty((h, w), np.int64)
    for r in range(h):
        row = d[r]
        if r in first_rows:
            out[r] = (initial + np.cumsum(row)) & mask
            continue
        prev = out[r - 1]
        x0 = (row[0] + prev[0]) & mask
        if psv == 1:
            out[r] = (prev[0] + np.cumsum(row)) & mask
        elif psv == 2:
            out[r] = (row + prev) & mask
        elif psv == 3:
            out[r, 0] = x0
            out[r, 1:] = (row[1:] + prev[:-1]) & mask
        elif psv in (4, 5):
            # Ra enters additively: a running sum
            step = prev[1:] - prev[:-1]
            if psv == 5:
                step >>= 1
            out[r, 0] = x0
            out[r, 1:] = (x0 + np.cumsum(row[1:] + step)) & mask
        else:
            x, vals = x0, [x0]
            rl, pl = row.tolist(), prev.tolist()
            for c in range(1, w):
                if psv == 6:
                    x = (rl[c] + pl[c] + ((x - pl[c - 1]) >> 1)) & mask
                else:
                    x = (rl[c] + ((x + pl[c]) >> 1)) & mask
                vals.append(x)
            out[r] = vals
    return out


# ---------------------------------------------------------------------------
# Block smoothing (jdcoefct.c::decompress_smooth_data)
# ---------------------------------------------------------------------------

# jdcoefct.c::SAVED_COEFS: block smoothing estimates the first 9 AC
# coefficients (zig-zag 1-9) and looks at their coef_bits and the DC's
_SMOOTHED_COEFS = 10


def _grid(rows) -> np.ndarray:
    return np.array(rows, np.int64)


# the estimate of zig-zag coefficients 1-9 (AC01, AC10, AC20, AC11, AC02,
# AC03, AC12, AC21, AC30) as weights over the 5x5 DC values around a block
# (rows above to below, columns left to right), before Q00 / (Qk << 8):
# where only DC is known (which also re-estimates the DC) ...
_AC01 = _grid([[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
               [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]])
_AC20 = _grid([[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
               [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]])
_AC11 = _grid([[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0],
               [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]])
_AC03 = _grid([[0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0],
               [0, 1, 0, -1, 0], [0] * 5])
_AC12 = _grid([[0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0],
               [0] * 5])
_DC_ONLY = np.stack([_AC01, _AC01.T, _AC20, _AC11, _AC20.T, _AC03, _AC12,
                     _AC12.T, _AC03.T])
_DC_ESTIMATE = _grid([[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6],
                      [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
                      [-2, -6, -8, -6, -2]])
# ... and where some AC bits are known (zig-zag 1-5 only)
_P01 = _grid([[0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5])
_P02 = _grid([[0] * 5, [0] * 5, [-1, 13, -24, 13, -1], [0] * 5, [0] * 5])
_P11 = _grid([[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5,
              [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]])
_WITH_AC = np.stack([_P01, _P01.T, _P02.T, _P11, _P02])


def _smoothing_ok(comps) -> bool:
    """jdcoefct.c::smoothing_ok at the output pass: every component's DC
    seen and its DC and first 9 AC quantisers nonzero, and some AC
    coefficient among the first 9 still short of full precision."""
    useful = False
    for comp in comps:
        q = comp["qtable"]
        bits = comp["coef_bits"]
        if (q[NATURAL_ORDER[:_SMOOTHED_COEFS]] == 0).any() or bits[0] < 0:
            return False
        useful |= any(b != 0 for b in bits[1:_SMOOTHED_COEFS])
    return useful


def _dc_columns(width: int) -> np.ndarray:
    """The block columns decompress_smooth_data reads as the 5 DC values
    across (offsets -2..2) of each of ``width`` blocks: clamped to the
    component's blocks."""
    cols = np.arange(width)[:, None] + np.arange(-2, 3)[None, :]
    return np.clip(cols, 0, width - 1)


def _dc_rows(height: int, v: int, imcu_rows: int) -> np.ndarray:
    """The block rows decompress_smooth_data reads as the 5 DC values down
    (offsets -2..2) of each of a component's ``height`` block rows (``v``
    a row of MCUs, ``imcu_rows`` rows of MCUs). Its edge tests count the
    last row of MCUs as having as many block rows as it really has, and
    every earlier row as having that many too."""
    out = []
    for r in range(height):
        imcu, b = divmod(r, v)
        rows = v if imcu < imcu_rows - 1 else (height % v or v)
        row, total = imcu * rows + b, rows * imcu_rows
        prev = r - 1 if row > 0 else r
        prev2 = r - 2 if row > 1 else prev
        nxt = r + 1 if row < total - 1 else r
        nxt2 = r + 2 if row < total - 2 else nxt
        out.append([prev2, prev, r, nxt, nxt2])
    return np.array(out, np.int64)


def _smooth(coefs: np.ndarray, bits, q: np.ndarray, v: int,
            imcu_rows: int, height: int, width: int) -> np.ndarray:
    """jdcoefct.c::decompress_smooth_data on one component: ``coefs``
    [block rows, block columns, 64] (the whole MCU grid, natural order),
    ``bits`` its coef_bits (zig-zag), ``q`` its quantisation table;
    returns the [height, width] real blocks with the estimates in place of
    the coefficients still zero and not known to full precision (and every
    DC re-estimated where no AC bit is known)."""
    dc = coefs[..., 0].astype(np.int64)
    around = dc[_dc_rows(height, v, imcu_rows)[:, None, :, None],
                _dc_columns(width)[None, :, None, :]]     # [h, w, 5, 5]
    out = coefs[:height, :width].astype(np.int64)
    q = q.astype(np.int64)
    dc_only = all(b == -1 for b in bits[1:_SMOOTHED_COEFS])
    kernels = _DC_ONLY if dc_only else _WITH_AC

    def estimate(kernel, qk, al):
        num = q[0] * np.einsum("hwij,ij->hw", around, kernel)
        pred = ((qk << 7) + np.abs(num)) // (qk << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        return np.where(num >= 0, pred, -pred)

    for k, kernel in enumerate(kernels, start=1):
        at = NATURAL_ORDER[k]
        if bits[k] != 0:
            out[..., at] = np.where(out[..., at] == 0,
                                    estimate(kernel, q[at], bits[k]),
                                    out[..., at])
    if dc_only:
        out[..., 0] = estimate(_DC_ESTIMATE, q[0], 0)
    return out


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------

class _Decoder:
    """The state of one file's decoding: tables, frame, components, and the
    markers that set its colour space."""

    def __init__(self):
        self.quant, self.dc_tables, self.ac_tables = {}, {}, {}
        self.conditioning = {"dc": {}, "ac": {}}
        self.restart = 0
        self.frame = self.coding = self.process = None
        self.comps = []
        self.jfif, self.adobe, self.space = False, None, None

    def marker(self, marker: int, seg: bytes) -> None:
        """Read one marker segment other than SOS."""
        if marker in _REFUSED_SOF:
            raise NotImplementedError(_REFUSED_SOF[marker])
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
                self.quant[tq] = table
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                n = sum(counts)
                table = _Huffman(counts, list(seg[i + 17:i + 17 + n]))
                (self.ac_tables if tc else self.dc_tables)[th] = table
                i += 17 + n
        elif marker == 0xCC:
            # jdmarker.c::get_dac
            for i in range(0, len(seg) - 1, 2):
                index, val = seg[i], seg[i + 1]
                if index >= 32:
                    raise ValueError(f"JPEG: bad DAC index {index}")
                if index >= 16:
                    self.conditioning["ac"][index - 16] = val
                elif (val & 15) > (val >> 4):
                    raise ValueError(f"JPEG: bad DAC value {val}")
                else:
                    self.conditioning["dc"][index] = (val & 15, val >> 4)
        elif marker in _SOF:
            self.start_frame(marker, seg)
        elif marker == 0xDD:
            self.restart = struct.unpack(">H", seg[:2])[0]
        elif self.space is None and marker == 0xE0:
            # jdmarker.c::examine_app0: at least 14 bytes, "JFIF\0"
            self.jfif |= len(seg) >= 14 and seg[:5] == b"JFIF\0"
        elif self.space is None and marker == 0xEE:
            # jdmarker.c::examine_app14: at least 12 bytes, "Adobe"
            if len(seg) >= 12 and seg[:5] == b"Adobe":
                self.adobe = seg[11]
        # other APPn, COM and anything else with a length: skipped

    def start_frame(self, marker: int, seg: bytes) -> None:
        """Read a frame header: size, process, components (refusing what
        libjpeg-turbo refuses as PIL drives it)."""
        precision, height, width, n = struct.unpack(">BHHB", seg[:6])
        if precision != 8:
            raise NotImplementedError(f"{precision}-bit JPEG precision")
        if height == 0:
            raise NotImplementedError("JPEG height given by a DNL marker")
        self.frame = (height, width)
        self.coding, self.process = _SOF[marker]
        self.comps = [{"id": seg[6 + 3 * c], "h": seg[7 + 3 * c] >> 4,
                       "v": seg[7 + 3 * c] & 15, "tq": seg[8 + 3 * c]}
                      for c in range(n)]
        if any(not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4)
               for c in self.comps):
            raise ValueError("JPEG: sampling factors outside 1-4")
        if self.process == "progressive":
            for comp in self.comps:
                self.allocate(comp)

    def geometry(self):
        """(hmax, vmax, MCUs across, MCUs down) of the frame."""
        height, width = self.frame
        unit = 1 if self.process == "lossless" else 8
        hmax = max(c["h"] for c in self.comps)
        vmax = max(c["v"] for c in self.comps)
        return (hmax, vmax, -(-width // (unit * hmax)),
                -(-height // (unit * vmax)))

    def size(self, comp):
        """(rows, columns) of a component's own samples (libjpeg's
        downsampled_height and downsampled_width)."""
        height, width = self.frame
        hmax, vmax, _, _ = self.geometry()
        return -(-height * comp["v"] // vmax), -(-width * comp["h"] // hmax)

    def allocate(self, comp) -> None:
        """The component's coefficient store over the whole MCU grid, and
        the point transform each coefficient was last refined to
        (jdinput.c's ``coef_bits``: -1 until a scan sends it)."""
        _, _, mcux, mcuy = self.geometry()
        comp["blocks"] = (mcuy * comp["v"], mcux * comp["h"])
        comp["store"] = array("i", bytes(4 * 64 * comp["blocks"][0]
                                         * comp["blocks"][1]))
        comp["coef_bits"] = [-1] * 64

    def scan(self, header: bytes, segments) -> None:
        """Decode the scan whose SOS header is ``header`` and whose
        entropy-coded segments are ``segments``."""
        if self.frame is None:
            raise ValueError("JPEG: scan before the frame header")
        if self.space is None:
            # jdapimin.c::default_decompress_parms, at the first scan
            self.space = _colour_space([c["id"] for c in self.comps],
                                       self.jfif, self.adobe,
                                       self.process == "lossless")
            if self.process == "lossless" and self.space in ("YCbCr", "YCCK"):
                # libjpeg-turbo converts no colour in a lossless file
                raise NotImplementedError(f"lossless JPEG in {self.space}")
        n = header[0]
        by_id = {c["id"]: c for c in self.comps}
        ss, se = header[1 + 2 * n], header[2 + 2 * n]
        ah, al = header[3 + 2 * n] >> 4, header[3 + 2 * n] & 15
        scan = []
        for k in range(n):
            if header[1 + 2 * k] not in by_id:
                raise ValueError(f"JPEG: scan names component "
                                 f"{header[1 + 2 * k]}, not in the frame")
            comp = by_id[header[1 + 2 * k]]
            if "qtable" not in comp and self.process != "lossless":
                # jdinput.c::latch_quant_tables, at the component's first
                # scan
                if comp["tq"] not in self.quant:
                    raise ValueError(f"JPEG: quantisation table "
                                     f"{comp['tq']} is not defined")
                comp["qtable"] = self.quant[comp["tq"]].copy()
            scan.append((comp, header[2 + 2 * k] >> 4,
                         header[2 + 2 * k] & 15))
        if sum(c["h"] * c["v"] for c, _, _ in scan) > 10 and n > 1:
            raise ValueError("JPEG: more than 10 blocks in an MCU")
        if self.process == "lossless":
            self.lossless_scan(segments, scan, ss, se, ah, al)
        else:
            self.dct_scan(segments, scan, ss, se, ah, al)

    def layout(self, scan):
        """The blocks of an MCU of the scan and, for each MCU, their
        indices in the components' stores (the MCU grid for interleaved
        scans, the component's own blocks for a one-component scan)."""
        height, width = self.frame
        hmax, vmax, mcux, mcuy = self.geometry()
        if len(scan) == 1:
            comp = scan[0][0]
            bw = -(-(-(-width * comp["h"] // hmax)) // 8)
            bh = -(-(-(-height * comp["v"] // vmax)) // 8)
            stride = comp["blocks"][1]
            return [0], [(y * stride + x,) for y in range(bh)
                         for x in range(bw)]
        members, rel = [], []
        for k, (comp, _, _) in enumerate(scan):
            stride = comp["blocks"][1]
            for v in range(comp["v"]):
                for h in range(comp["h"]):
                    members.append(k)
                    rel.append((comp, v, h, stride))
        offsets = [tuple((my * comp["v"] + v) * stride + mx * comp["h"] + h
                         for comp, v, h, stride in rel)
                   for my in range(mcuy) for mx in range(mcux)]
        return members, offsets

    def dct_scan(self, segments, scan, ss, se, ah, al) -> None:
        progressive = self.process == "progressive"
        if not progressive and (ss != 0 or se != 63):
            raise ValueError("JPEG: spectral selection in a sequential scan")
        if progressive and (se > 63 or ss > se or (ss == 0) != (se == 0)
                            or (ss > 0 and len(scan) != 1)):
            raise ValueError(f"JPEG: bad progressive scan Ss={ss} Se={se} "
                             f"with {len(scan)} components")
        for comp, _, _ in scan:
            if "store" not in comp:
                self.allocate(comp)
        members, offsets = self.layout(scan)
        if self.coding == "arithmetic":
            blocks = [(scan[k][0]["store"], scan[k][1], scan[k][2], k)
                      for k in members]
            _decode_arith(segments, offsets, blocks, self.restart,
                          self.conditioning, progressive, ss, se, ah, al)
        else:
            blocks = []
            for k in members:
                comp, td, ta = scan[k]
                # a scan reads only the tables it uses
                dc = self.dc_tables.get(td) if ss == 0 and ah == 0 else None
                ac = (self.ac_tables.get(ta)
                      if se > 0 and (ah == 0 or progressive) else None)
                if ((ss == 0 and ah == 0 and dc is None)
                        or (se > 0 and ac is None)):
                    raise ValueError("JPEG: scan uses an undefined Huffman "
                                     "table")
                blocks.append((comp["store"], dc, ac, k))
            if progressive:
                _decode_progressive(segments, offsets, blocks, self.restart,
                                    ss, se, ah, al)
            else:
                _decode_scan(segments, offsets, blocks, self.restart)
        if progressive:
            for comp, _, _ in scan:
                comp["coef_bits"][ss:se + 1] = [al] * (se + 1 - ss)

    def lossless_scan(self, segments, scan, psv, se, ah, al) -> None:
        """A lossless scan: the differences of its components' samples,
        undifferenced (jddiffct.c::decompress_data: the first row of the
        scan, and the first row of each MCU row group in which a restart
        falls, take the first-row predictor)."""
        if not 1 <= psv <= 7 or se or ah or al >= 8:
            raise ValueError(f"JPEG: bad lossless scan Ss={psv} Se={se} "
                             f"Ah={ah} Al={al}")
        tables = []
        for comp, td, _ in scan:
            if td not in self.dc_tables:
                raise ValueError("JPEG: scan uses an undefined Huffman table")
            tables += [self.dc_tables[td]] * (
                1 if len(scan) == 1 else comp["h"] * comp["v"])
        _, _, mcux, mcuy = self.geometry()
        if len(scan) == 1:
            rows, per_row = self.size(scan[0][0])
        else:
            rows, per_row = mcuy, mcux
        if self.restart and self.restart % per_row:
            raise ValueError(f"JPEG: lossless restart interval "
                             f"{self.restart} is not a multiple of the "
                             f"{per_row} MCUs in an MCU row")
        flat = np.frombuffer(_decode_differences(
            segments, tables, rows * per_row, self.restart), np.int32)
        # MCU rows after which a restart falls, as MCU row groups
        step = self.restart // per_row if self.restart else 0
        restarts = range(step, rows, step) if step else ()
        offset = 0
        for comp, _, _ in scan:
            ch, cw = self.size(comp)
            if len(scan) == 1:
                diff = flat.reshape(ch, cw)
                group = comp["v"]
            else:
                h, v = comp["h"], comp["v"]
                units = flat.reshape(mcuy, mcux, -1)[..., offset:offset + h * v]
                offset += h * v
                diff = units.reshape(mcuy, mcux, v, h).transpose(0, 2, 1, 3)
                diff = diff.reshape(mcuy * v, mcux * h)[:ch, :cw]
                group = 1
            first = {0} | {(y // group) * comp["v"] for y in restarts}
            samples = _undifference(diff, psv, 1 << (8 - al - 1), first)
            comp["samples"] = ((samples << al) & 0xFF).astype(np.uint8)

    def finish(self) -> np.ndarray:
        """Dequantise, smooth, inverse-DCT, upsample and colour-convert (or,
        lossless, upsample the samples and colour-convert)."""
        if self.frame is None:
            raise ValueError("JPEG: no frame header")
        height, width = self.frame
        hmax, vmax, _, mcuy = self.geometry()
        lossless = self.process == "lossless"
        key = "samples" if lossless else "store"
        for comp in self.comps:
            if key not in comp:
                raise ValueError(f"JPEG component {comp['id']} has no scan")
        smooth = self.process == "progressive" and _smoothing_ok(self.comps)
        planes = []
        for comp in self.comps:
            ch, cw = self.size(comp)
            if lossless:
                plane = comp["samples"]
            else:
                bh, bw = comp["blocks"]
                coefs = np.frombuffer(comp["store"], np.int32).reshape(
                    bh, bw, 64)
                if smooth:
                    coefs = _smooth(coefs, comp["coef_bits"], comp["qtable"],
                                    comp["v"], mcuy, -(-ch // 8), -(-cw // 8))
                rows, cols = coefs.shape[:2]
                pixels = idct_islow(coefs.reshape(-1, 64), comp["qtable"])
                plane = pixels.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3)
                plane = plane.reshape(rows * 8, cols * 8)[:ch, :cw]
            plane = _upsample(plane, comp["h"], comp["v"], hmax, vmax,
                              fancy=not lossless)
            planes.append(plane[:height, :width])
        return _pixels(planes, self.space)


def _segments(data: bytes):
    """The marker segments of a JPEG byte string after SOI, up to EOI:
    yields (marker, body, and for SOS, whose body is the scan header, the
    scan's entropy-coded segments; None for the others)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
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
            return
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2:pos + length]
        pos += length
        scan = None
        if marker == 0xDA:
            scan, pos = _split_scan(data, pos)
        yield marker, seg, scan


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a JPEG byte string as PIL does (see the module docstring) ->
    [H, W] uint8 grey, [H, W, 3] uint8 RGB or [H, W, 4] uint8 CMYK."""
    dec = _Decoder()
    for marker, seg, scan in _segments(data):
        if scan is None:
            dec.marker(marker, seg)
        else:
            dec.scan(seg, scan)
    return dec.finish()


def read_jpeg(path) -> np.ndarray:
    """The pixels of the JPEG file at ``path``, as ``np.array(Image.open(
    path))`` gives them: [H, W] grey, [H, W, 3] RGB or [H, W, 4] CMYK,
    uint8."""
    return decode_jpeg(Path(path).read_bytes())


def _frame_header(path):
    """(height, width, components) of the JPEG file at ``path``, from its
    frame header."""
    data = Path(path).read_bytes()
    for marker, seg, _ in _segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return struct.unpack(">HHB", seg[1:6])
    raise ValueError(f"{path}: no JPEG frame header")


def jpeg_size(path) -> tuple:
    """(width, height) of the JPEG file at ``path``, read from its frame
    header without decoding (as ``Image.open(path).size``)."""
    height, width, _ = _frame_header(path)
    return width, height


def jpeg_mode(path) -> str:
    """PIL's mode of the JPEG file at ``path``: "L", "RGB" or "CMYK" for
    1, 3 or 4 components, from its frame header."""
    components = _frame_header(path)[2]
    modes = {1: "L", 3: "RGB", 4: "CMYK"}
    if components not in modes:
        raise NotImplementedError(f"JPEG with {components} components")
    return modes[components]


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
