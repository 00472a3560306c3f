"""Bytes that one launch of the density kernel (K1) needs.

A frozen copy of ``chip_smoke.py``'s arithmetic (``brick_coords``,
``weighted``, ``corner_lanes``, ``atlas_needs``): the atlas elements that
samples with a non-zero hat weight read, each counted once however many
samples read it, plus 12 bytes of position in and 4 bytes of value out a
sample. Over the HBM rate this is the least time the launch could take.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
LANES = 128
# lanes of a sample's 2x2x2 corners, relative to lane a0*25+b0*5+c0
CORNER_LANES = (0, 1, 5, 6, 25, 26, 30, 31)


def brick_coords(grid_dim, xyz: torch.Tensor):
    """[P,3] coords in [-1,1] -> (atlas row [P], in-brick position [P,3])
    for the atlas of 4-voxel bricks, ceil((g-1)/4) a side."""
    gx, gy, gz = (int(g) for g in grid_dim)
    by, bz = -(-(gy - 1) // 4), -(-(gz - 1) // 4)
    g = torch.tensor((gx, gy, gz), dtype=torch.float32, device=xyz.device)
    p = (xyz + 1.0) * 0.5 * (g - 1.0)
    cell = torch.minimum(torch.clamp(torch.floor(p), min=0.0), g - 2.0)
    brick = cell.to(torch.int64) // 4
    row = (brick[:, 0] * by + brick[:, 1]) * bz + brick[:, 2]
    return row, p - 4.0 * brick.to(torch.float32)


def weighted(frac: torch.Tensor) -> torch.Tensor:
    """[P] whether a sample has a non-zero hat weight on every axis."""
    return ((frac > -1.0) & (frac < 5.0)).all(dim=1)


def corner_lanes(frac: torch.Tensor) -> torch.Tensor:
    lo = torch.clamp(torch.floor(frac), 0, 3).to(torch.int64)
    base = lo[:, 0] * 25 + lo[:, 1] * 5 + lo[:, 2]
    return base[:, None] + torch.tensor(CORNER_LANES, device=frac.device)


def launch_bytes(xyz: torch.Tensor, grid_dim, elem_bytes: int,
                 step: int = 1 << 22) -> int:
    """Bytes a launch on samples ``xyz`` [P,3] needs: distinct atlas
    elements read, and positions in and values out."""
    keys = []
    for part in torch.split(xyz, step):
        row, frac = brick_coords(grid_dim, part)
        w = weighted(frac)
        keys.append(torch.unique(row[w, None] * LANES + corner_lanes(frac[w])))
    elems = int(torch.unique(torch.cat(keys)).numel()) if keys else 0
    return elems * elem_bytes + 16 * xyz.shape[0]
