"""VM-decomposition factor-grid sampling: direct bilinear/linear lookups.

Port of ``contrastive_lift_tpu/ops/grid_sample.py``. The JAX package writes
the lookup as gather + lerp; its convention is torch's
``F.grid_sample(align_corners=True, padding_mode="zeros")``, which is what
this module calls, forward and backward (the backward is a scatter-add into
the factor grids).

Conventions:
  * plane: [C, H, W]; a sample coordinate (x, y) in [-1, 1] maps to pixel
    ((x+1)/2*(W-1), (y+1)/2*(H-1)); x indexes W, y indexes H.
  * line: [C, L]; coordinate z in [-1, 1] maps to (z+1)/2*(L-1).
  * out-of-range corners contribute zero.

The VM split: plane i of a branch has shape [C, grid[m1], grid[m0]] and is
sampled at (x=xyz[m0], y=xyz[m1]); line i has shape [C, grid[v]] sampled at
xyz[v], with (m0, m1) = MATRIX_MODE[i] and v = VECTOR_MODE[i].

``upsample_plane`` and ``upsample_line`` resize factors between training
stages by sampling them on the target's align-corners lattice, as the JAX
package does (``lattice``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

MATRIX_MODE = ((0, 1), (0, 2), (1, 2))
VECTOR_MODE = (2, 1, 0)


def plane_sample(plane: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a [C, H, W] plane at [P, 2] coords in [-1, 1].
    Returns [P, C]; zero outside the grid."""
    out = F.grid_sample(plane[None], xy.reshape(1, 1, -1, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[0, :, 0, :].t()


def line_sample(line: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Linear sample of a [C, L] line at [P] coords in [-1, 1]. Returns
    [P, C]. The line is a [C, L, 1] image read at x = 0, as the reference
    stores it."""
    grid = torch.stack([torch.zeros_like(z), z], dim=-1)
    out = F.grid_sample(line[None, :, :, None], grid.reshape(1, 1, -1, 2),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out[0, :, 0, :].t()


def _axis_product(planes, lines, xyz: torch.Tensor, i: int) -> torch.Tensor:
    m0, m1 = MATRIX_MODE[i]
    p = plane_sample(planes[i], xyz[:, (m0, m1)])
    return p * line_sample(lines[i], xyz[:, VECTOR_MODE[i]])


def vm_density(planes, lines, xyz: torch.Tensor) -> torch.Tensor:
    """Density feature: the sum over the 3 VM axes of sum_c(plane_c * line_c).
    planes/lines: 3 tensors each ([C,H,W] / [C,L]); xyz [P, 3] in [-1,1].
    Returns [P] (the caller applies the shift and softplus)."""
    total = torch.zeros(xyz.shape[0], dtype=xyz.dtype, device=xyz.device)
    for i in range(3):
        total = total + torch.sum(_axis_product(planes, lines, xyz, i), dim=-1)
    return total


def vm_feature(planes, lines, xyz: torch.Tensor) -> torch.Tensor:
    """Concatenated plane*line features over the 3 axes: [P, sum(C_i)] (the
    caller applies the bias-free basis matmul)."""
    return torch.cat([_axis_product(planes, lines, xyz, i) for i in range(3)],
                     dim=-1)


def lattice(start: float, stop: float, n: int, device=None) -> torch.Tensor:
    """``n`` float32 points from ``start`` to ``stop`` as XLA computes
    ``jnp.linspace`` inside a jitted function: step ``i * f32(1 / (n - 1))``,
    then ``start * (1 - step) + stop * step``, the last point ``stop``
    (``torch.linspace`` differs from it in the last bit at about half the
    points; the JAX package's eager ``jnp.linspace(-1, 1, n)`` by up to one
    float32 step). One point is ``start``."""
    if n == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    inv = torch.tensor(1.0, **f32) / torch.tensor(float(n - 1), **f32)
    step = torch.arange(n - 1, **f32) * inv
    out = (torch.tensor(start, **f32) * (1.0 - step)
           + torch.tensor(stop, **f32) * step)
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


def upsample_plane(plane: torch.Tensor, new_hw) -> torch.Tensor:
    """Bilinear (align_corners=True) resize of a [C, H, W] plane to
    [C, new_h, new_w]: the plane sampled on the target's lattice in
    [-1, 1] (a size of 1 samples the centre)."""
    C = plane.shape[0]
    nh, nw = int(new_hw[0]), int(new_hw[1])
    ys = lattice(-1.0, 1.0, nh, plane.device) if nh > 1 else \
        torch.zeros(1, device=plane.device)
    xs = lattice(-1.0, 1.0, nw, plane.device) if nw > 1 else \
        torch.zeros(1, device=plane.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")          # [nh, nw]
    out = plane_sample(plane, torch.stack([gx.reshape(-1), gy.reshape(-1)],
                                          dim=-1))          # [nh*nw, C]
    return out.t().reshape(C, nh, nw).contiguous()


def upsample_line(line: torch.Tensor, new_l: int) -> torch.Tensor:
    """Linear (align_corners=True) resize of a [C, L] line to [C, new_l]."""
    nl = int(new_l)
    zs = lattice(-1.0, 1.0, nl, line.device) if nl > 1 else \
        torch.zeros(1, device=line.device)
    return line_sample(line, zs).t().contiguous()
