"""The port's image codecs and resizes against PIL and ``jax.image``.

``utils/png.py::read_png`` and ``utils/jpeg.py::read_jpeg`` stand in for
``np.array(Image.open(path))``, and ``utils/image.py`` for PIL's NEAREST and
LANCZOS resizes and ``jax.image.resize(method="bilinear")``, on a machine
without PIL or JAX. Bars:

- PNG reading and NEAREST resizing: ``array_equal`` with PIL;
- JPEG decoding: within 1 level of PIL everywhere and equal on at least
  99.9% of the values (the decoder follows libjpeg-turbo's integer IDCT,
  upsampling and colour tables, so in practice it is equal);
- LANCZOS: ``array_equal`` with PIL (the same fixed-point coefficients);
- bilinear: within 1e-6 of ``jax.image.resize`` (float32 sums in another
  order).

Run as a script, the file prints the seconds the host takes to decode a
968x1296 quality-95 4:2:0 frame (``python tests/test_torch_port_codecs.py``).
"""
import io
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
    resize_bilinear_chw, resize_lanczos_uint8, resize_nearest)
from contrastive_lift_tpu_torch.utils.jpeg import (  # noqa: E402
    decode_jpeg, jpeg_size, read_jpeg)
from contrastive_lift_tpu_torch.utils.png import read_png, write_png  # noqa: E402

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
    np.testing.assert_array_equal(got, pixels)
    want = np.array(Image.open(path))
    if depth == 16 and channels > 1:
        got = (got >> 8).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


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


def test_read_png_refuses_interlace(tmp_path):
    """An Adam7 file (IHDR interlace method 1) raises, naming it."""
    header = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 1)
    body = zlib.compress(bytes(4 * 5 + 8))
    (tmp_path / "i.png").write_bytes(
        b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
        + _png_chunk(b"IDAT", body) + _png_chunk(b"IEND", b""))
    with pytest.raises(NotImplementedError, match="Adam7"):
        read_png(tmp_path / "i.png")


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


def test_jpeg_refuses_progressive():
    data = _jpeg_bytes(_image(24, 24, 3), progressive=True)
    with pytest.raises(NotImplementedError, match="progressive"):
        decode_jpeg(data)


NEAREST_CASES = [((37, 53), (64, 96)), ((64, 96), (13, 11)),
                 ((64, 96), (37, 53)), ((480, 640), (97, 129)),
                 ((7, 5), (100, 7)), ((64, 96), (3, 200))]


@pytest.mark.parametrize("hw,out", NEAREST_CASES)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.int16])
def test_resize_nearest_matches_pil(hw, out, dtype):
    """Non-integer up and down ratios, for the dtypes the readers resize
    (uint8 L, uint16 I;16, int32 and int16 as PIL's mode I)."""
    rng = np.random.default_rng(0)
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
    seconds, size = frame_decode_seconds()
    print(f"decode_jpeg: {FRAME_HW[0]}x{FRAME_HW[1]} quality-95 4:2:0 frame "
          f"({size} bytes): {seconds:.3f} s (median of 3, host CPU)")
