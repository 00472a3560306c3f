"""Image resizes of the scene readers, without PIL or JAX.

The port's counterparts of the resizes in ``contrastive_lift_tpu/data/
panopli.py:41-57`` and ``data/mos.py``:

- ``resize_nearest``: PIL's ``Image.resize(..., NEAREST)`` for any ratio
  (Geometry.c: the source position of each output pixel in double
  precision, truncated; accumulated pixel by pixel by
  ``ImagingScaleAffine``, except for uint16 images, PIL's ``I;16``, which
  take the generic transform's direct product);
- ``resize_lanczos_uint8``: PIL's ``Image.resize(..., LANCZOS)`` of 8-bit
  images (Resample.c: the horizontal pass, then the vertical one, with
  coefficients in fixed point of ``PRECISION_BITS = 22`` and a uint8 clip
  between the passes; RGBA premultiplied by alpha around the resize as PIL
  does, CMYK not);
- ``resize_bilinear_chw``: ``jax.image.resize(method="bilinear")`` of
  [..., h, w] float arrays, antialiased when it downscales, as one
  separable weight matrix per axis in torch with float32 accumulation;
- ``to_grey_pil``: PIL's ``convert("L")`` (ITU-R 601-2 luma in 16-bit
  fixed point; CMYK through PIL's CMYK -> RGB first);
- ``read_image``: ``np.asarray(Image.open(path))`` for the PNG and JPEG
  files the preprocessing scripts open, ``image_palette``: the colours of
  a palette PNG's indices, and ``image_mode``: PIL's mode of the file,
  which tells a CMYK JPEG from an RGBA image of the same shape.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .jpeg import decode_jpeg, jpeg_mode, jpeg_size
from .png import decode_png, png_palette

# Resample.c: 32 bits - 8 bits of sample - 2 bits of headroom
PRECISION_BITS = 32 - 8 - 2
LANCZOS_SUPPORT = 3.0


def resize_nearest(arr: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """PIL ``NEAREST`` resize of [h, w] or [h, w, c] to ``hw`` = (H, W), as
    ``Image.fromarray(arr).resize`` gives it for ``arr``'s dtype."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    out_h, out_w = hw
    if (h, w) == (out_h, out_w):
        return arr.copy()
    direct = arr.dtype == np.uint16

    def positions(n_in: int, n_out: int) -> np.ndarray:
        step = n_in / n_out
        if direct:
            pos = step * (np.arange(n_out) + 0.5)
        else:
            pos = np.cumsum(np.concatenate([[step * 0.5],
                                            np.full(n_out - 1, step)]))
        return np.where(pos < 0, -1, pos.astype(np.int64))

    ys, xs = positions(h, out_h), positions(w, out_w)
    out = arr[np.clip(ys, 0, h - 1)][:, np.clip(xs, 0, w - 1)]
    # PIL leaves the pixels it finds no source for at zero
    outside = ((ys < 0) | (ys >= h))[:, None] | ((xs < 0) | (xs >= w))[None]
    if outside.any():
        out[outside] = 0
    return out


def _lanczos(x: float) -> float:
    def sinc(v: float) -> float:
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v
    if -3.0 <= x < 3.0:
        return sinc(x) * sinc(x / 3)
    return 0.0


def lanczos_coefficients(in_size: int, out_size: int):
    """Resample.c::precompute_coeffs + normalize_coeffs_8bpc for the whole
    axis: (first source index [out], number of source samples [out],
    fixed-point weights [out, ksize] int64, zero past each pixel's
    support)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    count = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        for x, v in enumerate(k):
            v = v / ww if ww != 0.0 else v
            kk[xx, x] = int((0.5 if v >= 0 else -0.5) + v * (1 << PRECISION_BITS))
        first[xx], count[xx] = xmin, xmax
    return first, count, kk


def _pass(src: np.ndarray, first: np.ndarray, kk: np.ndarray) -> np.ndarray:
    """One 8-bit pass along axis 0 of ``src`` [n, ...]: out[i] = clip8(
    2^21 + sum_k src[first[i] + k] * kk[i, k])."""
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]), len(src) - 1)
    acc = np.full((len(first),) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    s = src.astype(np.int64)
    for k in range(kk.shape[1]):
        wk = kk[:, k].reshape((-1,) + (1,) * (src.ndim - 1))
        acc += s[idx[:, k]] * wk
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _muldiv255(a, b):
    tmp = a * b + 128
    return ((tmp >> 8) + tmp) >> 8


def resize_lanczos_uint8(arr: np.ndarray, hw: Tuple[int, int],
                         mode: Optional[str] = None) -> np.ndarray:
    """PIL ``LANCZOS`` resize of a uint8 [h, w] (L), [h, w, 2] (LA),
    [h, w, 3] (RGB) or [h, w, 4] (RGBA, or CMYK where ``mode`` is "CMYK")
    image to ``hw`` = (H, W)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"resize_lanczos_uint8 takes uint8, got {arr.dtype}")
    h, w = arr.shape[:2]
    out_h, out_w = hw
    if (h, w) == (out_h, out_w):
        return arr.copy()
    rgba = arr.ndim == 3 and arr.shape[2] in (2, 4) and mode != "CMYK"
    if rgba:
        # PIL resizes LA and RGBA premultiplied, as La and RGBa
        # (Convert.c::rgbA2rgba)
        a32 = arr.astype(np.int64)
        arr = np.concatenate([_muldiv255(a32[..., :-1], a32[..., -1:]),
                              a32[..., -1:]], axis=-1).astype(np.uint8)
    first_v, count_v, kk_v = lanczos_coefficients(h, out_h)
    out = arr
    if out_w != w:
        # Resample.c: only the source rows the vertical pass reads
        y0, y1 = int(first_v[0]), int(first_v[-1] + count_v[-1])
        first_h, _, kk_h = lanczos_coefficients(w, out_w)
        out = _pass(out[y0:y1].swapaxes(0, 1), first_h, kk_h).swapaxes(0, 1)
        first_v = first_v - y0
    if out_h != h:
        out = _pass(out, first_v, kk_v)
    if rgba:
        # Convert.c::rgba2rgbA
        o = out.astype(np.int64)
        alpha = o[..., -1:]
        safe = np.where((alpha == 0) | (alpha == 255), 255, alpha)
        rgb = np.where((alpha == 0) | (alpha == 255), o[..., :-1],
                       np.clip((255 * o[..., :-1]) // safe, 0, 255))
        out = np.concatenate([rgb, alpha], axis=-1).astype(np.uint8)
    return np.ascontiguousarray(out)


def _bilinear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """jax.image.compute_weight_mat for the triangle kernel with
    antialiasing, in float32: [n_in, n_out]. The sample positions take one
    rounding of (i + 0.5) * inv_scale - 0.5, as the multiply-add that XLA
    fuses them into (exact in float64, then rounded to float32)."""
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5)
              * inv_scale - 0.5).float()
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    weights = torch.clamp(1 - (x / kernel_scale).abs(), min=0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0)


def resize_bilinear_chw(arr, hw: Tuple[int, int]) -> np.ndarray:
    """``jax.image.resize(arr, arr.shape[:-2] + hw, "bilinear")`` of a float
    [..., h, w] array: the half-pixel-centre triangle filter, widened by the
    scale when it downscales. Computed in float32 on the host, as the
    readers load scenes there."""
    x = torch.as_tensor(np.asarray(arr, np.float32))
    h, w = x.shape[-2:]
    out_h, out_w = hw
    if out_h != h:
        x = torch.einsum("...hw,hH->...Hw", x, _bilinear_weights(h, out_h, x.device))
    if out_w != w:
        x = torch.einsum("...hw,wW->...hW", x, _bilinear_weights(w, out_w, x.device))
    return x.cpu().numpy()


def cmyk_to_rgb(image: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of a CMYK [h, w, 4] uint8 image
    (Convert.c::cmyk2rgb: each of R, G, B is (255 - K) - (C or M or Y) *
    (255 - K) / 255, the product rounded as MULDIV255)."""
    cmyk = np.asarray(image).astype(np.int64)
    nk = 255 - cmyk[..., 3:]
    return np.clip(nk - _muldiv255(cmyk[..., :3], nk), 0, 255).astype(
        np.uint8)


def to_grey_pil(image: np.ndarray, palette: Optional[np.ndarray] = None,
                mode: Optional[str] = None) -> np.ndarray:
    """PIL's ``convert("L")`` of a uint8 image: RGB and RGBA through
    Convert.c's L24, (19595 R + 38470 G + 7471 B + 0x8000) >> 16 (alpha
    ignored); grey returned as is, bool (mode 1) as 0 and 255, uint16 grey
    (I;16) clipped to 255, and grey + alpha without its alpha. With
    ``palette`` ([N, 3], ``image_palette``), ``image`` holds its indices
    (PIL's mode P), converted through their colours as Convert.c's p2l.
    With ``mode`` "CMYK" (``image_mode``), a [h, w, 4] image is CMYK, which
    PIL converts to RGB first (``cmyk_to_rgb``)."""
    image = np.asarray(image)
    if palette is not None:
        image = np.asarray(palette)[image]
    if mode == "CMYK":
        image = cmyk_to_rgb(image)
    if image.ndim == 2:
        if image.dtype == np.bool_:
            return image.astype(np.uint8) * 255
        if image.dtype == np.uint16:
            return np.minimum(image, 255).astype(np.uint8)
        return image.copy()
    if image.ndim == 3 and image.shape[2] == 2:
        return image[..., 0].copy()
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"to_grey_pil takes grey, LA, RGB or RGBA, got "
                         f"{image.shape}")
    rgb = image[..., :3].astype(np.int64)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
             + 0x8000) >> 16).astype(np.uint8)


# leading bytes of the formats PIL opens and the port does not
_OTHER_FORMATS = ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\0", "TIFF"),
                  (b"MM\0*", "TIFF"), (b"RIFF", "WebP"), (b"\0\0\0\x0cjP", "JPEG 2000"))


def _format_error(path, data: bytes) -> ValueError:
    name = next((n for magic, n in _OTHER_FORMATS if data.startswith(magic)),
                f"an unknown format (first bytes {data[:8].hex()})")
    return ValueError(f"{path}: {name} image; the port reads PNG and JPEG")


def image_size(path) -> Tuple[int, int]:
    """(width, height) of a PNG or JPEG file from its header, as
    ``Image.open(path).size``."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        return tuple(int(v) for v in np.frombuffer(head[16:24], ">u4"))
    if head[:2] == b"\xff\xd8":
        return jpeg_size(path)
    raise _format_error(path, head)


def read_image(path) -> np.ndarray:
    """``np.asarray(Image.open(path))`` of a PNG or JPEG file, told apart by
    its first bytes (``utils/png.py``, ``utils/jpeg.py``). Any other format
    raises ``ValueError`` naming it."""
    data = Path(path).read_bytes()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    raise _format_error(path, data)


# PIL's mode of a PNG by (colour type, bit depth): grey 1-bit as mode 1,
# 16-bit as I;16, 16-bit colour as 8-bit, 16-bit grey + alpha as RGBA
_PNG_MODES = {(0, 1): "1", (0, 16): "I;16", (4, 16): "RGBA"}
_PNG_COLOUR_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def image_mode(path) -> str:
    """PIL's mode of a PNG or JPEG file (``Image.open(path).mode``), from
    its header: what ``read_image``'s array is (a [h, w, 4] array is RGBA,
    or CMYK from a four-component JPEG)."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        depth, colour = head[24], head[25]
        return _PNG_MODES.get((colour, depth), _PNG_COLOUR_MODES[colour])
    if head[:2] == b"\xff\xd8":
        return jpeg_mode(path)
    raise _format_error(path, head)


def image_palette(path) -> Optional[np.ndarray]:
    """The [N, 3] uint8 colours of a palette PNG, whose ``read_image`` gives
    the indices (PIL's mode P, which PIL resizes NEAREST whatever filter it
    is asked for); None for any other PNG or JPEG."""
    data = Path(path).read_bytes()
    return png_palette(data) if data[:8] == b"\x89PNG\r\n\x1a\n" else None


def resize_pil(image: np.ndarray, hw: Tuple[int, int], lanczos: bool,
               mode: Optional[str] = None) -> np.ndarray:
    """``Image.open(path).resize(hw[::-1], LANCZOS or NEAREST)`` for the
    images ``read_image`` gives, ``mode`` being the file's (``image_mode``):
    a copy at the same size; NEAREST for every dtype (and for bool, PIL's
    mode 1, and a palette image's indices, mode P, which PIL never
    filters); LANCZOS for uint8 grey, LA, RGB, RGBA and CMYK."""
    image = np.asarray(image)
    if tuple(image.shape[:2]) == tuple(hw):
        return image.copy()
    if not lanczos or image.dtype == np.bool_ or mode == "P":
        return resize_nearest(image, hw)
    if image.dtype != np.uint8:
        raise ValueError(f"LANCZOS resize of {image.dtype} images is not "
                         "ported (the port resizes uint8 ones)")
    return resize_lanczos_uint8(image, hw, mode)
