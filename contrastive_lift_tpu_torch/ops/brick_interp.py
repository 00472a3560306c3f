"""Brick-atlas trilinear interpolation: the CUDA kernel's wrappers and plain versions.

Port of the repository's only TPU kernel, ``contrastive_lift_tpu/ops/
pallas_interp.py::brick_interp``, and of its XLA twin
``contrastive_lift_tpu/ops/fused_grid.py::sample_density_brick``, which every
dense-path sample goes through. The kernel is ``csrc/brick_interp.cu``, CUDA
C++ for ``sm_90a``; it is compiled by ``nvcc`` into ``_build/`` at first use
(again whenever the source changes) and bound with ``ctypes``.

Three entry points:

* ``brick_interp(rows [P,128], frac [P,3]) -> [P]``: the literal counterpart
  of the Pallas kernel;
* ``sample_density_brick(atlas [B,128], xyz [P,3], grid_dim, splus_shift)``:
  the fused form the renderer calls, which finds each sample's atlas row
  itself;
* ``sample_density_brick_span(atlas, xyz [R,K,T,3], grid_dim, splus_shift,
  rows_per_span)``: the span form, port of the JAX package's
  ``ops/fused_grid.py::sample_density_brick_span`` (the renderer's opt-in
  ``fine_span_rows``): the T consecutive samples of each of a ray's K spans
  read at most ``rows_per_span`` atlas rows.

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
        lib.sample_density_brick_span_launch.argtypes = [
            p, i32, p, p, i64, i32, i32, i32, i32, i32, ctypes.c_float, p]
        lib.sample_density_brick_span_launch.restype = i32
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
    # the kernels read rows in aligned 16-B chunks (brick_interp its corner
    # pairs, sample_density_brick and its span form the rows they stage)
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


# samples per step of the plain fused version: its [P,128] intermediates
# take 512 B a sample, and a render's calibration probe passes millions
REFERENCE_STEP = 1 << 20


def sample_density_brick_reference(atlas: torch.Tensor, xyz: torch.Tensor,
                                   grid_dim, splus_shift: float) -> torch.Tensor:
    """Plain version of ``sample_density_brick``: row gather + 128-lane hat
    reduction, as the JAX package computes it (``REFERENCE_STEP`` samples at
    a time; each sample's value is computed on its own)."""
    _check_rows_dtype("atlas", atlas)
    _check_positions_dtype("xyz", xyz)
    out = []
    for part in torch.split(xyz, REFERENCE_STEP):
        row, frac = brick_coords(grid_dim, part)
        out.append(brick_interp_reference(atlas[row], frac) + splus_shift)
    return torch.cat(out) if len(out) != 1 else out[0]


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


# span forms the kernel takes: samples a span, atlas rows a span
MAX_SPAN_LEN = 32
MAX_SPAN_ROWS = 16


def span_runs(grid_dim, xyz: torch.Tensor, rows_per_span: int):
    """The runs of [R,K,T,3] spans, as the JAX function finds them: (moves
    [R,K,T], each sample's count of brick changes before it in its span;
    run_row [R,K,W], the atlas row of each run once the count is clamped to
    ``rows_per_span`` - 1: the largest brick among its samples, -1 for a
    run no sample falls in; frac [R*K*T,3], each sample's in-brick
    position)."""
    R, K, T, _ = xyz.shape
    row, frac = brick_coords(grid_dim, xyz.reshape(-1, 3))
    row = row.reshape(R, K, T)
    moves = torch.nn.functional.pad(
        torch.cumsum(row[..., 1:] != row[..., :-1], dim=-1), (1, 0))
    run = torch.clamp(moves, max=rows_per_span - 1)
    eq = run[..., None] == torch.arange(rows_per_span, device=xyz.device)
    run_row = torch.where(eq, row[..., None], -1).amax(dim=2)
    return moves, run_row, frac


def sample_density_brick_span_reference(atlas: torch.Tensor, xyz: torch.Tensor,
                                        grid_dim, splus_shift: float,
                                        rows_per_span: int) -> torch.Tensor:
    """Plain version of ``sample_density_brick_span``, the JAX function's
    algorithm: each sample reads the row of its run (``span_runs``; row 0
    for an empty run, which no sample reads), selected by a masked sum that
    adds exact zeros, then the 128-lane hat reduction of
    ``sample_density_brick_reference``, so where no run is clamped the
    values are that function's bit for bit. ``REFERENCE_STEP`` samples'
    rays at a time."""
    _check_rows_dtype("atlas", atlas)
    _check_positions_dtype("xyz", xyz)
    R, K, T, _ = xyz.shape
    W = rows_per_span
    out = []
    for part in torch.split(xyz, max(1, REFERENCE_STEP // max(1, K * T))):
        moves, run_row, frac = span_runs(grid_dim, part, W)
        run = torch.clamp(moves, max=W - 1)
        rows = atlas[torch.clamp(run_row, min=0)].to(torch.float32)
        sel = torch.zeros(part.shape[:3] + (LANES,), dtype=torch.float32,
                          device=xyz.device)
        for w in range(W):
            sel = sel + torch.where((run == w)[..., None],
                                    rows[:, :, w, None, :], 0.0)
        out.append((brick_interp_reference(sel.reshape(-1, LANES), frac)
                    + splus_shift).reshape(part.shape[:3]))
    return torch.cat(out) if len(out) != 1 else out[0]


def sample_density_brick_span(atlas: torch.Tensor, xyz: torch.Tensor,
                              grid_dim, splus_shift: float,
                              rows_per_span: int) -> torch.Tensor:
    """Pre-activation density + shift at [R,K,T,3] float32 coords in [-1,1]
    whose T samples of each (ray, span) are consecutive along the ray, from
    ``rows_per_span`` atlas rows per span; [R,K,T] float32 out. The kernel
    takes T up to ``MAX_SPAN_LEN`` and ``rows_per_span`` up to
    ``MAX_SPAN_ROWS``."""
    if atlas.device.type == "cpu":
        return sample_density_brick_span_reference(atlas, xyz, grid_dim,
                                                   splus_shift, rows_per_span)
    if atlas.device.type != "cuda":
        raise ValueError(f"sample_density_brick_span runs on cuda or cpu, "
                         f"not {atlas.device}")
    _check_rows_dtype("atlas", atlas)
    _check_positions_dtype("xyz", xyz)
    _check_rows("atlas", atlas, atlas.device)
    if xyz.dim() != 4 or xyz.shape[3] != 3:
        raise ValueError(f"xyz must be [R, K, T, 3], got {tuple(xyz.shape)}")
    if xyz.device != atlas.device:
        raise ValueError(f"xyz is on {xyz.device}, expected {atlas.device}")
    if not xyz.is_contiguous():
        raise ValueError("xyz must be contiguous")
    R, K, T, _ = xyz.shape
    if not 1 <= T <= MAX_SPAN_LEN:
        raise ValueError(f"sample_density_brick_span takes spans of 1 to "
                         f"{MAX_SPAN_LEN} samples, got {T}")
    if not 2 <= rows_per_span <= MAX_SPAN_ROWS:
        raise ValueError(f"sample_density_brick_span takes 2 to "
                         f"{MAX_SPAN_ROWS} rows a span, got {rows_per_span}")
    gx, gy, gz = (int(g) for g in grid_dim)
    bx, by, bz = brick_atlas_dims(grid_dim)
    if min(gx, gy, gz) < 2 or atlas.shape[0] != bx * by * bz:
        raise ValueError(f"atlas has {atlas.shape[0]} rows; grid {grid_dim} "
                         f"needs {bx}*{by}*{bz}")
    out = torch.empty((R, K, T), dtype=torch.float32, device=atlas.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(atlas.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sample_density_brick_span_launch(
            atlas.data_ptr(), ROW_DTYPES[atlas.dtype], xyz.data_ptr(),
            out.data_ptr(), R * K, T, int(rows_per_span), gx, gy, gz,
            float(splus_shift), stream)
    _raise_on(err, "sample_density_brick_span")
    _count_launch(sample_density_brick_span, atlas.dtype)
    return out


KERNELS = (brick_interp, sample_density_brick, sample_density_brick_span)


def reset_launches():
    """Zero every wrapper's launch counts."""
    for wrapper in KERNELS:
        wrapper.dtype_launches = {}


def launch_total(wrapper) -> int:
    """Launches of ``wrapper``'s kernel over all row types."""
    return sum(wrapper.dtype_launches.values())


reset_launches()
