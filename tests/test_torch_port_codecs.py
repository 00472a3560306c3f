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
  IDCT, upsampling and colour tables, so in practice it is equal);
  progressive decoding: ``array_equal`` with PIL;
- LANCZOS and the grey conversion: ``array_equal`` with PIL (the same
  fixed-point coefficients);
- bilinear: within 1e-6 of ``jax.image.resize`` (float32 sums in another
  order).

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
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from contrastive_lift_tpu_torch.utils.image import (  # noqa: E402
    image_palette, image_size, read_image, resize_bilinear_chw,
    resize_lanczos_uint8, resize_nearest, resize_pil, to_grey_pil)
from contrastive_lift_tpu_torch.utils.jpeg import (  # noqa: E402
    decode_jpeg, encode_jpeg, jpeg_size, read_jpeg, write_jpeg)
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


def _marker_file(marker: int) -> bytes:
    """SOI, then a marker segment of its own, then EOI."""
    body = bytes([8, 0, 16, 0, 16, 1, 1, 0x11, 0]) if marker != 0xCC else (
        bytes([0x00, 0x10]))
    return (b"\xff\xd8" + struct.pack(">BBH", 0xFF, marker, len(body) + 2)
            + body + b"\xff\xd9")


@pytest.mark.parametrize("marker,process", [
    (0xC3, "lossless JPEG (SOF3)"), (0xC5, "hierarchical JPEG (SOF5)"),
    (0xC9, "arithmetic-coded JPEG (SOF9)"),
    (0xCC, "arithmetic-coded JPEG (DAC)")])
def test_jpeg_refuses_process(marker, process):
    """The processes the decoder does not read raise, naming the process:
    lossless, hierarchical (which libjpeg refuses too) and arithmetic
    coding (its frame headers, and the DAC segment that only such files
    hold)."""
    with pytest.raises(NotImplementedError, match=re.escape(process)):
        decode_jpeg(_marker_file(marker))


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


def test_progressive_jpeg_refuses_block_smoothing():
    """A progressive file cut after its first scans leaves low-frequency AC
    bits unsent, where libjpeg would smooth the blocks: refused, naming
    block smoothing."""
    data = _jpeg_bytes(_image(24, 32, 3), progressive=True, quality=90)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    cut = data[:sos[3]] + b"\xff\xd9"
    with pytest.raises(NotImplementedError, match="block smoothing"):
        decode_jpeg(cut)


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
