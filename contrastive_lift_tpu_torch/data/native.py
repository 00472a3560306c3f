"""ctypes bindings for the native ray-pool library (``native/raypool.cpp``).

The port's copy of ``contrastive_lift_tpu/data/native.py``. The library is
built on first use with ``g++ -O3 -fopenmp`` from the repository's
``native/raypool.cpp`` into the port's own ``_build/`` directory (rebuilt
when the source changes); ``native/`` itself is only read. Without a
compiler every entry point computes the same values with numpy, as in the
JAX package.

The library's OpenMP runtime is the one torch's CPU operations run on, so
the thread count it sets would become torch's intra-op thread count as
well (the JAX package has no such coupling). Each native call therefore
runs on ``set_num_threads``' count and puts torch's count back after it.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "raypool.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-Wall")
_lib: Optional[ctypes.CDLL] = None
_tried = False
_pending_threads: Optional[int] = None


def set_num_threads(n: int) -> None:
    """Cap the OpenMP threads of the native ray pool's calls (<= 0 keeps
    the OpenMP default)."""
    global _pending_threads
    if n <= 0:
        return
    _pending_threads = int(n)


def _call(fn, *args) -> None:
    """``fn(*args)`` on the ray pool's threads, torch's count restored."""
    if _pending_threads is None:
        fn(*args)
        return
    import torch
    threads = torch.get_num_threads()
    _lib.set_num_threads(_pending_threads)
    try:
        fn(*args)
    finally:
        torch.set_num_threads(threads)


def library_path() -> Path:
    """Where the library of the current source is built."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libraypool_{digest}.so"


def _build() -> Path:
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.so")
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        tmp.replace(path)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.build_rays.argtypes = [ctypes.c_int, ctypes.c_int, f32p, f32p,
                                   ctypes.c_float, f32p]
        lib.gather_rows_f32.argtypes = [f32p, i64p, ctypes.c_int64,
                                        ctypes.c_int, f32p]
        lib.gather_rows_i32.argtypes = [i32p, i64p, ctypes.c_int64,
                                        ctypes.c_int, i32p]
        lib.gather_rows_u8.argtypes = [u8p, i64p, ctypes.c_int64,
                                       ctypes.c_int, u8p]
        lib.sample_indices.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_uint64, i64p]
        lib.set_num_threads.argtypes = [ctypes.c_int]
        _lib = lib
    except Exception as exc:  # no compiler / unsupported platform
        print(f"[native] raypool unavailable ({exc}); using numpy")
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def build_rays(height: int, width: int, intrinsics: np.ndarray,
               cam2world: np.ndarray, near: float = 0.01) -> np.ndarray:
    """[H*W, 8] ray bundle, natively when the library loads."""
    lib = _load()
    if lib is not None:
        out = np.empty((height * width, 8), np.float32)
        _call(lib.build_rays, height, width,
              np.ascontiguousarray(intrinsics[:3, :3], np.float32),
              np.ascontiguousarray(cam2world[:4, :4], np.float32),
              np.float32(near), out)
        return out
    from ..utils import geometry as geo
    dirs = geo.ray_directions_from_intrinsics(height, width, intrinsics)
    return np.asarray(geo.make_ray_bundle(dirs, cam2world, near), np.float32)


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[k] = src[idx[k]], with native row copies when possible."""
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    src2 = src.reshape(len(src), -1)
    if lib is not None and src2.flags.c_contiguous:
        out = np.empty((len(idx), src2.shape[1]), src2.dtype)
        fns = {np.dtype(np.float32): lib.gather_rows_f32,
               np.dtype(np.int32): lib.gather_rows_i32,
               np.dtype(np.uint8): lib.gather_rows_u8}
        if src2.dtype not in fns:
            return src[idx]
        _call(fns[src2.dtype], src2, idx, len(idx), src2.shape[1], out)
        return out.reshape((len(idx),) + src.shape[1:])
    return src[idx]


def sample_indices(n_pool: int, batch: int, seed: int) -> np.ndarray:
    lib = _load()
    if lib is not None:
        out = np.empty(batch, np.int64)
        _call(lib.sample_indices, n_pool, batch, np.uint64(seed), out)
        return out
    return np.random.default_rng(seed).integers(0, n_pool, batch)
