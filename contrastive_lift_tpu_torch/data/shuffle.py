"""numpy's permutations, drawn natively on the caller's PCG64 stream.

``heads(rng, sizes, keep)`` is ``[rng.permutation(n)[:keep] for n in
sizes]``: the same indices, and the generator left in the same state. Where
it can, it makes them in one call of the library ``csrc/shuffle.cpp``, which
draws numpy's numbers in numpy's order from the generator's own state, read
and written back through ``rng.bit_generator.state`` under the generator's
lock. Otherwise it calls numpy: for a bit generator other than ``PCG64``, a
size of 2^31 or more, or when the library did not build or did not pass its
check against ``rng.permutation`` on loading.

The library is built on first use with ``g++ -O3`` into the port's
``_build/`` directory (rebuilt when the source changes). It uses no OpenMP:
the draws are serial (and ``data/native.py`` says what OpenMP's runtime
would do to torch's thread count). While a profiler collects, each call
counts the elements it shuffles (``sample.shuffled``) and those shuffled
natively (``sample.native``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..utils.observability import count

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "shuffle.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-Wall")
LIMIT = 1 << 31        # the library's sizes are below this
_MASK = (1 << 64) - 1
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libshuffle_{digest}.so"


def _open() -> ctypes.CDLL:
    """The library, built unless this source already is."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.pcg64_permutation_heads.argtypes = [
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
    lib.pcg64_permutation_heads.restype = ctypes.c_int
    return lib


def numpy_heads(rng: np.random.Generator, sizes: Sequence[int],
                keep: int) -> List[np.ndarray]:
    """``heads`` by numpy's own ``permutation``."""
    return [rng.permutation(n)[:keep] for n in sizes]


def _native_heads(lib, rng: np.random.Generator, sizes: Sequence[int],
                  keep: int) -> List[np.ndarray]:
    sizes = np.asarray(sizes, np.int64)
    out = np.empty((len(sizes), keep), np.int64)
    bits = rng.bit_generator
    with bits.lock:
        got = bits.state
        s, inc = got["state"]["state"], got["state"]["inc"]
        st = np.array([s >> 64, s & _MASK, inc >> 64, inc & _MASK,
                       got["has_uint32"], got["uinteger"]], np.uint64)
        if lib.pcg64_permutation_heads(st, sizes, len(sizes), keep, out):
            raise ValueError(f"sizes out of [0, {LIMIT}) or no memory")
        bits.state = {"bit_generator": got["bit_generator"],
                      "state": {"state": int(st[0]) << 64 | int(st[1]),
                                "inc": inc},
                      "has_uint32": int(st[4]), "uinteger": int(st[5])}
    return [row[:min(int(n), keep)] for row, n in zip(out, sizes)]


# (seed, a half pending, sizes, keep) of the check made on loading: the
# smallest sizes, each side of powers of two, a band cut by ``keep``
_CHECKS = ((0, False, (0, 1, 2, 3, 4, 5, 7, 8, 9, 255, 256, 257), 300),
           (1, True, (1025, 2, 65537, 6, 4097), 1024),
           (2 ** 40 + 3, True, (70000, 3000, 1), 16))


def _agrees(lib) -> bool:
    """The library gives ``numpy_heads``' indices and state on ``_CHECKS``."""
    for seed, pending, sizes, keep in _CHECKS:
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        if pending:
            state = {**a.bit_generator.state, "has_uint32": 1,
                     "uinteger": 0x9E3779B9}
            a.bit_generator.state = b.bit_generator.state = state
        want = numpy_heads(a, sizes, keep)
        got = _native_heads(lib, b, sizes, keep)
        if (a.bit_generator.state != b.bit_generator.state
                or any(not np.array_equal(x, y) for x, y in zip(want, got))):
            return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = _open()
    except (OSError, subprocess.CalledProcessError) as exc:
        print(f"[shuffle] native permutations unavailable ({exc}); "
              "using numpy")
        return None
    if _agrees(lib):
        _lib = lib
    else:
        print("[shuffle] native permutations differ from numpy's; "
              "using numpy")
    return _lib


def native_available() -> bool:
    return _load() is not None


def heads(rng: np.random.Generator, sizes: Sequence[int],
          keep: int) -> List[np.ndarray]:
    """``[rng.permutation(n)[:keep] for n in sizes]``, in that order, the
    generator left as those calls leave it; natively for a ``PCG64``
    generator and sizes under 2^31 when the library loads."""
    total = int(sum(sizes))
    count("sample.shuffled", total)
    if (type(rng.bit_generator) is np.random.PCG64
            and max(sizes, default=0) < LIMIT):
        lib = _load()
        if lib is not None:
            count("sample.native", total)
            return _native_heads(lib, rng, sizes, keep)
    return numpy_heads(rng, sizes, keep)
