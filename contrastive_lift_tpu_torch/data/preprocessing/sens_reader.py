"""ScanNet .sens binary stream parser (format version 4): the port's copy
of ``contrastive_lift_tpu/data/preprocessing/sens_reader.py``.

The .sens container interleaves a header (sensor name, color/depth
intrinsics + extrinsics, compression types, resolutions, depth shift) with
per-frame records (camera_to_world, timestamps, jpeg or png color bytes,
zlib'ed uint16 depth). Frames stream lazily; colour payloads decode through
``utils/jpeg.py`` and ``utils/png.py``.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ...utils.jpeg import decode_jpeg
from ...utils.png import decode_png

COMPRESSION_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort",
                     2: "occi_ushort"}


@dataclass
class SensHeader:
    sensor_name: str
    intrinsic_color: np.ndarray
    extrinsic_color: np.ndarray
    intrinsic_depth: np.ndarray
    extrinsic_depth: np.ndarray
    color_compression: str
    depth_compression: str
    color_width: int
    color_height: int
    depth_width: int
    depth_height: int
    depth_shift: float
    num_frames: int


@dataclass
class SensFrame:
    camera_to_world: np.ndarray
    timestamp_color: int
    timestamp_depth: int
    color_bytes: bytes
    depth_bytes: bytes

    def color_image(self) -> np.ndarray:
        """Decode the jpeg/png color payload (told apart by its first
        bytes, as PIL does) to an RGB array."""
        if self.color_bytes[:2] == b"\xff\xd8":
            return decode_jpeg(self.color_bytes)
        if self.color_bytes[:8] == b"\x89PNG\r\n\x1a\n":
            return decode_png(self.color_bytes)
        raise ValueError("colour payload is neither JPEG nor PNG (first "
                         f"bytes {self.color_bytes[:8].hex()})")

    def depth_image(self, header: SensHeader) -> np.ndarray:
        """Decode depth to meters [H, W] float32."""
        if header.depth_compression == "zlib_ushort":
            raw = zlib.decompress(self.depth_bytes)
        elif header.depth_compression == "raw_ushort":
            raw = self.depth_bytes
        else:
            raise NotImplementedError(header.depth_compression)
        depth = np.frombuffer(raw, np.uint16).reshape(
            header.depth_height, header.depth_width)
        return depth.astype(np.float32) / header.depth_shift


def _read_mat4(f) -> np.ndarray:
    return np.frombuffer(f.read(16 * 4), np.float32).reshape(4, 4).copy()


def read_header(f) -> SensHeader:
    version = struct.unpack("I", f.read(4))[0]
    if version != 4:
        raise ValueError(f"unsupported .sens version {version}")
    strlen = struct.unpack("Q", f.read(8))[0]
    name = f.read(strlen).decode("ascii", errors="replace")
    intr_c, extr_c, intr_d, extr_d = (_read_mat4(f) for _ in range(4))
    comp_c = COMPRESSION_COLOR[struct.unpack("i", f.read(4))[0]]
    comp_d = COMPRESSION_DEPTH[struct.unpack("i", f.read(4))[0]]
    cw, ch, dw, dh = struct.unpack("IIII", f.read(16))
    shift = struct.unpack("f", f.read(4))[0]
    num_frames = struct.unpack("Q", f.read(8))[0]
    return SensHeader(name, intr_c, extr_c, intr_d, extr_d, comp_c, comp_d,
                      cw, ch, dw, dh, shift, num_frames)


def iter_frames(path, frame_skip: int = 1,
                max_frames: Optional[int] = None) -> Iterator[tuple]:
    """Yield (index, SensHeader, SensFrame) streaming from a .sens file."""
    with open(Path(path), "rb") as f:
        header = read_header(f)
        yielded = 0
        for i in range(header.num_frames):
            cam2world = _read_mat4(f)
            ts_c, ts_d, n_color, n_depth = struct.unpack("QQQQ", f.read(32))
            color = f.read(n_color)
            depth = f.read(n_depth)
            if i % frame_skip:
                continue
            yield i, header, SensFrame(cam2world, ts_c, ts_d, color, depth)
            yielded += 1
            if max_frames is not None and yielded >= max_frames:
                return


def write_sens(path, header: SensHeader, frames) -> Path:
    """Write a version-4 .sens file: ``header`` (its ``num_frames`` is
    taken from ``frames``) and ``frames``, a sequence of SensFrame whose
    payloads are already compressed as the header says."""
    frames = list(frames)
    compression = {v: k for k, v in COMPRESSION_COLOR.items()}
    depth_kind = {v: k for k, v in COMPRESSION_DEPTH.items()}
    name = header.sensor_name.encode("ascii")
    parts = [struct.pack("<I", 4), struct.pack("<Q", len(name)), name]
    parts += [np.asarray(m, np.float32).tobytes() for m in (
        header.intrinsic_color, header.extrinsic_color,
        header.intrinsic_depth, header.extrinsic_depth)]
    parts.append(struct.pack("<ii", compression[header.color_compression],
                             depth_kind[header.depth_compression]))
    parts.append(struct.pack("<IIIIf", header.color_width,
                             header.color_height, header.depth_width,
                             header.depth_height, header.depth_shift))
    parts.append(struct.pack("<Q", len(frames)))
    for fr in frames:
        parts += [np.asarray(fr.camera_to_world, np.float32).tobytes(),
                  struct.pack("<QQQQ", fr.timestamp_color, fr.timestamp_depth,
                              len(fr.color_bytes), len(fr.depth_bytes)),
                  fr.color_bytes, fr.depth_bytes]
    path = Path(path)
    path.write_bytes(b"".join(parts))
    return path
