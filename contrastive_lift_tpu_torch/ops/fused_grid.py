"""Dense grids built from the VM factors, and their samplers (dense render path).

Port of the parts of ``contrastive_lift_tpu/ops/fused_grid.py`` that the
dense render reads. Trilinear interpolation is multilinear, so each
factorized field plane(x,y) * line(z) equals the trilinear interpolation of
one dense voxel grid built from the factors; the density becomes a brick
atlas sampled by the ``brick_interp`` kernel, the projected appearance (and
any other VM branch) a dense [g^3, F] grid sampled with 8 row reads.

Not ported on purpose: the corner-redundant feature table
(``_cell_corner_feature``) is a TPU gather layout, one 8-corner row per cell.
At the r5b grid it would hold 2,028,000 rows of 256 floats (about 2 GB), and
the 8-read dense-grid branch of ``sample_feature_fused`` computes the same
trilinear value. The occupancy tables and compact tables serve empty-space
skipping, a later slice.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from . import brick_interp as bi


class FusedGrids(NamedTuple):
    """Dense grids for one set of parameters (built once per render)."""
    grid_dim: Tuple[int, int, int]
    brick_atlas: torch.Tensor           # [Bx*By*Bz, 128] f32 or bf16
    features: Dict[str, torch.Tensor]   # branch -> [gx*gy*gz, out_dim]


def build_dense_density(params: dict) -> torch.Tensor:
    """[gx, gy, gz] pre-activation density grid (without the softplus shift)."""
    planes = params["density"]["planes"]
    lines = params["density"]["lines"]
    d = torch.einsum("cyx,cz->xyz", planes[0], lines[0])
    d = d + torch.einsum("czx,cy->xyz", planes[1], lines[1])
    d = d + torch.einsum("czy,cx->xyz", planes[2], lines[2])
    return d


def build_dense_feature(params: dict, name: str) -> torch.Tensor:
    """[gx*gy*gz, out_dim] dense projected feature grid for a VM branch.

    dense[v] = concat_axis(plane (.) line)[v] @ basis, with the basis matmul
    folded in per axis (block rows of the basis matrix)."""
    planes = params[name]["planes"]
    lines = params[name]["lines"]
    basis = params[f"{name}_basis"]["w"]
    offs = 0
    total = None
    einsums = ("cyx,cz->xyzc", "czx,cy->xyzc", "czy,cx->xyzc")
    for i in range(3):
        c = planes[i].shape[0]
        prod = torch.einsum(einsums[i], planes[i], lines[i])
        contrib = torch.einsum("xyzc,cf->xyzf", prod, basis[offs:offs + c])
        total = contrib if total is None else total + contrib
        offs += c
    gx, gy, gz, f = total.shape
    return total.reshape(gx * gy * gz, f)


def build_brick_atlas(dense: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[gx,gy,gz] pre-activation density -> [Bx*By*Bz, 128] brick rows of
    ``dtype`` (float32 or bfloat16; rounded from the float32 grid).

    Brick (i,j,k) covers voxels [4i,4i+4]x[4j,..]x[4k,..]; its row holds the
    5^3 corner lattice at lane a*25+b*5+c (edge-clamped at grid boundaries),
    zero-padded to 128 lanes. Port of ``_build_brick_atlas(dense, dtype)``."""
    if dtype not in bi.ROW_DTYPES:
        raise TypeError(f"brick atlas dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    bx, by, bz = bi.brick_atlas_dims(dense.shape)
    idx = [torch.clamp(torch.arange(4 * b + 1, device=dense.device), max=g - 1)
           for b, g in zip((bx, by, bz), dense.shape)]
    padded = dense[idx[0]][:, idx[1]][:, :, idx[2]]
    corners = [padded[a:a + 4 * bx - 3:4, b:b + 4 * by - 3:4, c:c + 4 * bz - 3:4]
               for a in range(5) for b in range(5) for c in range(5)]
    atlas = torch.stack(corners, dim=-1).reshape(bx * by * bz, 125)
    return torch.nn.functional.pad(atlas, (0, bi.LANES - 125)).to(dtype)


def build_render_grids(params: dict,
                       atlas_dtype: str = "float32") -> FusedGrids:
    """What the dense render reads: the density brick atlas, of
    ``atlas_dtype`` (``RenderConfig.atlas_dtype``: "float32" or "bfloat16"),
    and a dense projected grid for every VM feature branch of ``params``
    (appearance; the semantic / instance branches of grid-head models)."""
    dense = build_dense_density(params)
    features = {name: build_dense_feature(params, name)
                for name in ("appearance", "semantic", "instance")
                if name in params}
    return FusedGrids(tuple(dense.shape),
                      build_brick_atlas(dense, getattr(torch, atlas_dtype)),
                      features)


def sample_density_brick(fused: FusedGrids, xyz: torch.Tensor,
                         splus_shift: float) -> torch.Tensor:
    """Pre-activation density + shift at [P,3] coords in [-1,1]: one atlas
    row per sample, interpolated by the ``brick_interp`` kernel."""
    return bi.sample_density_brick(fused.brick_atlas, xyz.contiguous(),
                                   fused.grid_dim, splus_shift)


def _cell_coords(grid_dim, xyz: torch.Tensor):
    g = torch.tensor(grid_dim, dtype=torch.float32, device=xyz.device)
    p = (xyz + 1.0) * 0.5 * (g - 1.0)
    i = torch.minimum(torch.clamp(torch.floor(p), min=0.0), g - 2.0)
    return i.to(torch.int64), p - i


def _corner_weights(f: torch.Tensor) -> torch.Tensor:
    """Trilinear corner weights [P, 8] from in-cell fractions [P, 3]
    (corner order dx, dy, dz with dz fastest)."""
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    return torch.cat([
        (1 - fx) * (1 - fy) * (1 - fz), (1 - fx) * (1 - fy) * fz,
        (1 - fx) * fy * (1 - fz), (1 - fx) * fy * fz,
        fx * (1 - fy) * (1 - fz), fx * (1 - fy) * fz,
        fx * fy * (1 - fz), fx * fy * fz], dim=-1)


def sample_feature_fused(fused: FusedGrids, name: str,
                         xyz: torch.Tensor) -> torch.Tensor:
    """Projected branch features at [P,3] coords in [-1,1]: 8 row reads of
    the dense grid (the dense-grid branch of the JAX function)."""
    gx, gy, gz = fused.grid_dim
    i, f = _cell_coords(fused.grid_dim, xyz)
    grid = fused.features[name]
    base = (i[:, 0] * gy + i[:, 1]) * gz + i[:, 2]
    w = _corner_weights(f)
    out = 0.0
    k = 0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = base + (dx * gy + dy) * gz + dz
                out = out + grid[idx].to(torch.float32) * w[:, k:k + 1]
                k += 1
    return out
