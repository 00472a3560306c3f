"""Brick-atlas trilinear interpolation: the CUDA kernel's wrappers and plain versions.

Port of the repository's only TPU kernel, ``contrastive_lift_tpu/ops/
pallas_interp.py::brick_interp``, and of its XLA twin
``contrastive_lift_tpu/ops/fused_grid.py::sample_density_brick``, which every
dense-path sample goes through. The kernel is ``csrc/brick_interp.cu``, CUDA
C++ for ``sm_90a``; it is compiled by ``nvcc`` into ``_build/`` at first use
(again whenever the source changes) and bound with ``ctypes``.

Two entry points:

* ``brick_interp(rows [P,128], frac [P,3]) -> [P]``: the literal counterpart
  of the Pallas kernel;
* ``sample_density_brick(atlas [B,128], xyz [P,3], grid_dim, splus_shift)``:
  the fused form the renderer calls, which finds each sample's atlas row
  itself.

Rows and atlas are float32 or bfloat16, as the TPU kernel takes them
(``pallas_interp.py`` casts its rows to float32 in the kernel body); the
arithmetic is float32 after the load, and positions and outputs are float32.
Each wrapper takes its plain PyTorch version (``*_reference``, the 128-lane
hat reduction of the JAX code) only for tensors on the CPU; for a CUDA tensor
it launches the kernel or raises. ``<wrapper>.dtype_launches`` counts kernel
launches by row type (``launch_total`` sums them), so a run can show that it
went through the kernel; ``reset_launches()`` zeroes the counts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

LANES = 128
# row / atlas types the kernel takes, and the code its C entry points expect
ROW_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "brick_interp.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "brick_interp kernel cannot be built")
    return str(path)


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbrick_interp_{digest}.so"


def build() -> Path:
    """Compile ``csrc/brick_interp.cu`` unless this source is already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.brick_interp_launch.argtypes = [p, i32, p, p, i64, p]
        lib.brick_interp_launch.restype = i32
        lib.sample_density_brick_launch.argtypes = [p, i32, p, p, i64, i32,
                                                    i32, i32, ctypes.c_float, p]
        lib.sample_density_brick_launch.restype = i32
        _lib = lib
    return _lib


def _check_rows_dtype(name: str, t: torch.Tensor):
    if t.dtype not in ROW_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")


def _check_positions_dtype(name: str, t: torch.Tensor):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")


def _check(name: str, t: torch.Tensor, width: int, device: torch.device):
    if t.dim() != 2 or t.shape[1] != width:
        raise ValueError(f"{name} must be [N, {width}], got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(name: str, t: torch.Tensor, device: torch.device):
    _check(name, t, LANES, device)
    # both kernels read rows in aligned 16-B chunks (brick_interp its corner
    # pairs, sample_density_brick the rows a warp stages whole)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start at a 16-byte aligned address")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _count_launch(wrapper, dtype: torch.dtype):
    key = str(dtype).removeprefix("torch.")
    wrapper.dtype_launches[key] = wrapper.dtype_launches.get(key, 0) + 1


def brick_atlas_dims(grid_dim):
    """Atlas brick counts per axis: ceil((g-1)/4)."""
    return tuple(-(-(int(g) - 1) // 4) for g in grid_dim)


def _lane_lattice(device):
    lane = torch.arange(LANES, device=device)
    return [x.to(torch.float32) for x in (lane // 25, (lane // 5) % 5, lane % 5)]


def _hat_weights(frac: torch.Tensor) -> torch.Tensor:
    """[P,3] in-brick positions -> [P,128] hat weights over the 5^3 lattice
    (lane a*25+b*5+c; the 3 pad lanes get weight 0)."""
    a, b, c = _lane_lattice(frac.device)
    return (torch.clamp(1.0 - torch.abs(frac[:, 0:1] - a), min=0.0)
            * torch.clamp(1.0 - torch.abs(frac[:, 1:2] - b), min=0.0)
            * torch.clamp(1.0 - torch.abs(frac[:, 2:3] - c), min=0.0))


def brick_coords(grid_dim, xyz: torch.Tensor):
    """[P,3] coords in [-1,1] -> (atlas row [P] int64, in-brick frac [P,3]),
    as ``contrastive_lift_tpu/ops/fused_grid.py::_brick_coords``."""
    gx, gy, gz = (int(g) for g in grid_dim)
    _, by, bz = brick_atlas_dims(grid_dim)
    g = torch.tensor((gx, gy, gz), dtype=torch.float32, device=xyz.device)
    p = (xyz + 1.0) * 0.5 * (g - 1.0)
    cell = torch.minimum(torch.clamp(torch.floor(p), min=0.0), g - 2.0)
    brick = cell.to(torch.int64) // 4
    row = (brick[:, 0] * by + brick[:, 1]) * bz + brick[:, 2]
    return row, p - 4.0 * brick.to(torch.float32)


def brick_interp_reference(rows: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Plain version of ``brick_interp``: the dense 128-lane hat reduction,
    in float32 after widening the rows."""
    _check_rows_dtype("rows", rows)
    _check_positions_dtype("frac", frac)
    return torch.sum(rows.to(torch.float32) * _hat_weights(frac), dim=1)


def sample_density_brick_reference(atlas: torch.Tensor, xyz: torch.Tensor,
                                   grid_dim, splus_shift: float) -> torch.Tensor:
    """Plain version of ``sample_density_brick``: row gather + 128-lane hat
    reduction, as the JAX package computes it."""
    _check_rows_dtype("atlas", atlas)
    _check_positions_dtype("xyz", xyz)
    row, frac = brick_coords(grid_dim, xyz)
    return brick_interp_reference(atlas[row], frac) + splus_shift


def brick_interp(rows: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """[P,128] brick rows (float32 or bfloat16) + [P,3] float32 in-brick
    positions -> [P] float32 trilinear values."""
    if rows.device.type == "cpu":
        return brick_interp_reference(rows, frac)
    if rows.device.type != "cuda":
        raise ValueError(f"brick_interp runs on cuda or cpu, not {rows.device}")
    _check_rows_dtype("rows", rows)
    _check_positions_dtype("frac", frac)
    _check_rows("rows", rows, rows.device)
    _check("frac", frac, 3, rows.device)
    n = rows.shape[0]
    if frac.shape[0] != n:
        raise ValueError(f"rows has {n} rows, frac {frac.shape[0]}")
    out = torch.empty(n, dtype=torch.float32, device=rows.device)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.brick_interp_launch(rows.data_ptr(), ROW_DTYPES[rows.dtype],
                                      frac.data_ptr(), out.data_ptr(), n,
                                      stream)
    _raise_on(err, "brick_interp")
    _count_launch(brick_interp, rows.dtype)
    return out


def sample_density_brick(atlas: torch.Tensor, xyz: torch.Tensor, grid_dim,
                         splus_shift: float) -> torch.Tensor:
    """Pre-activation density + shift at [P,3] float32 coords in [-1,1] from
    the brick atlas [B,128] (float32 or bfloat16) of a grid of ``grid_dim``
    voxels; float32 out."""
    if atlas.device.type == "cpu":
        return sample_density_brick_reference(atlas, xyz, grid_dim, splus_shift)
    if atlas.device.type != "cuda":
        raise ValueError(f"sample_density_brick runs on cuda or cpu, not "
                         f"{atlas.device}")
    _check_rows_dtype("atlas", atlas)
    _check_positions_dtype("xyz", xyz)
    _check_rows("atlas", atlas, atlas.device)
    _check("xyz", xyz, 3, atlas.device)
    gx, gy, gz = (int(g) for g in grid_dim)
    bx, by, bz = brick_atlas_dims(grid_dim)
    if min(gx, gy, gz) < 2 or atlas.shape[0] != bx * by * bz:
        raise ValueError(f"atlas has {atlas.shape[0]} rows; grid {grid_dim} "
                         f"needs {bx}*{by}*{bz}")
    n = xyz.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=atlas.device)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(atlas.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sample_density_brick_launch(
            atlas.data_ptr(), ROW_DTYPES[atlas.dtype], xyz.data_ptr(),
            out.data_ptr(), n, gx, gy, gz, float(splus_shift), stream)
    _raise_on(err, "sample_density_brick")
    _count_launch(sample_density_brick, atlas.dtype)
    return out


KERNELS = (brick_interp, sample_density_brick)


def reset_launches():
    """Zero every wrapper's launch counts."""
    for wrapper in KERNELS:
        wrapper.dtype_launches = {}


def launch_total(wrapper) -> int:
    """Launches of ``wrapper``'s kernel over all row types."""
    return sum(wrapper.dtype_launches.values())


reset_launches()
