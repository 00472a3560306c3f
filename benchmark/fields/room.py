"""A seeded room written into TensoRF's VM density factors.

A floor, a ceiling, four walls and axis-aligned boxes are exact rank-one
terms of the VM split: a box is b_x(x) b_y(y) b_z(z), which is one plane
(its footprint over x, y) times one line (its z extent) on axis 0. The
floor and ceiling share one axis-0 term (a plane of ones times the z slabs),
the walls at +-x one axis-2 term and the walls at +-y one axis-1 term, and
one more axis-1 term of constants lowers the whole field by ``background``
so that empty space is as empty as in a trained field. Boxes
that share a z extent share one term, whose plane is the union of their
footprints, so a room holds as many boxes as it likes within the axis-0
components left. Every other density component is zero.

Values are taken at the grid's align-corners lattice (index j of g at
-1 + 2 j / (g - 1)), so the field between lattice points is the trilinear
ramp that a trained TensoRF shows at a surface. Inside a surface the raw
density is ``amplitude + background`` (then the port's shift of -10 and a
softplus), in empty space ``background``: at -20, softplus(-30) = 9e-14,
so empty space adds nothing to transmittance, as in a trained field, and
a dense render and an empty-space-skipping one agree to rounding there.
"""
from __future__ import annotations

import numpy as np
import torch


def room_boxes(room: dict, seed: int) -> dict:
    """The boxes of a room spec (a traffic file's ``room``), from ``seed``:
    ``lo`` and ``hi`` [n, 3] corners and ``cls`` [n], the index of the z
    extent (``tops``) each stands to, every box on the floor."""
    rng = np.random.default_rng([int(seed), 0x524F4F4D])
    hx, hy = room["half_xy"]
    zf = room["floor"]
    n, k = room["boxes"], room["heights"]
    tops = zf + rng.uniform(*room["height"], size=k)
    size = rng.uniform(*room["size"], size=(n, 2))
    margin = room["wall_gap"]
    centre = np.stack([rng.uniform(-hx + margin + size[:, 0] / 2,
                                   hx - margin - size[:, 0] / 2),
                       rng.uniform(-hy + margin + size[:, 1] / 2,
                                   hy - margin - size[:, 1] / 2)], axis=1)
    cls = rng.integers(0, k, size=n)
    lo = np.concatenate([centre - size / 2, np.full((n, 1), zf)], axis=1)
    hi = np.concatenate([centre + size / 2, tops[cls][:, None]], axis=1)
    return {"lo": lo.astype(np.float32), "hi": hi.astype(np.float32),
            "cls": cls, "tops": tops.astype(np.float32)}


def lattice(g: int, device) -> torch.Tensor:
    return -1.0 + 2.0 * torch.arange(g, dtype=torch.float32,
                                     device=device) / (g - 1)


def _inside(coord, lo, hi):
    """[n, g] whether lattice coordinate g lies in [lo_n, hi_n]."""
    return ((coord[None, :] >= lo[:, None])
            & (coord[None, :] <= hi[:, None])).to(torch.float32)


def room_terms(room: dict, boxes: dict, grid_dim, device):
    """The room's rank-one terms: for each VM axis i a list of (plane,
    line) pairs (plane [g_m1, g_m0], line [g_v]), the amplitude in the
    lines."""
    gx, gy, gz = (int(g) for g in grid_dim)
    x, y, z = (lattice(g, device) for g in (gx, gy, gz))
    a = float(room["amplitude"])
    hx, hy = room["half_xy"]
    zf, zc = room["floor"], room["ceiling"]
    terms = [[], [], []]
    terms[0].append((torch.ones(gy, gx, device=device),
                     a * ((z <= zf) | (z >= zc)).to(torch.float32)))
    terms[1].append((torch.ones(gz, gx, device=device),
                     a * (y.abs() >= hy).to(torch.float32)))
    terms[2].append((torch.ones(gz, gy, device=device),
                     a * (x.abs() >= hx).to(torch.float32)))
    terms[1].append((torch.ones(gz, gx, device=device),
                     torch.full((gy,), float(room["background"]),
                                device=device)))
    lo = torch.as_tensor(boxes["lo"], device=device)
    hi = torch.as_tensor(boxes["hi"], device=device)
    cls = torch.as_tensor(boxes["cls"], device=device)
    in_x = _inside(x, lo[:, 0], hi[:, 0])              # [n, gx]
    in_y = _inside(y, lo[:, 1], hi[:, 1])              # [n, gy]
    for j, top in enumerate(boxes["tops"]):
        mine = cls == j
        if not bool(mine.any()):
            continue
        # union of the class's footprints: any box covers the lattice point
        cover = torch.einsum("ny,nx->yx", in_y[mine], in_x[mine])
        terms[0].append(((cover > 0).to(torch.float32),
                         a * ((z >= zf) & (z <= float(top))).to(torch.float32)))
    return terms


def write_room(params: dict, room: dict, boxes: dict) -> None:
    """Overwrite ``params``' density factors with the room, in place; raises
    when the room needs more terms on an axis than it has components."""
    d = params["density"]
    planes, lines = d["planes"], d["lines"]
    grid_dim = (planes[0].shape[2], planes[0].shape[1], lines[0].shape[1])
    terms = room_terms(room, boxes, grid_dim, planes[0].device)
    for i in range(3):
        if len(terms[i]) > planes[i].shape[0]:
            raise ValueError(f"the room needs {len(terms[i])} terms on VM "
                             f"axis {i}, which has {planes[i].shape[0]} "
                             f"components")
        planes[i].zero_()
        lines[i].zero_()
        for c, (p, l) in enumerate(terms[i]):
            planes[i][c] = p
            lines[i][c] = l


def dense_room(room: dict, boxes: dict, grid_dim, device) -> torch.Tensor:
    """The room's raw density [gx, gy, gz] at the lattice, written from the
    boxes and slabs directly (no factors): what ``write_room``'s factors
    must multiply out to."""
    gx, gy, gz = (int(g) for g in grid_dim)
    x, y, z = (lattice(g, device) for g in (gx, gy, gz))
    a = float(room["amplitude"])
    hx, hy = room["half_xy"]
    zf, zc = room["floor"], room["ceiling"]
    X, Y, Z = torch.meshgrid(x, y, z, indexing="ij")
    out = a * (((Z <= zf) | (Z >= zc)).float() + (Y.abs() >= hy).float()
               + (X.abs() >= hx).float()) + float(room["background"])
    for j, top in enumerate(boxes["tops"]):
        occupied = torch.zeros(gx, gy, dtype=torch.bool, device=device)
        for b in np.flatnonzero(boxes["cls"] == j):
            lo, hi = boxes["lo"][b], boxes["hi"][b]
            occupied |= ((X[:, :, 0] >= lo[0]) & (X[:, :, 0] <= hi[0])
                         & (Y[:, :, 0] >= lo[1]) & (Y[:, :, 0] <= hi[1]))
        slab = (z >= zf) & (z <= float(top))
        out = out + a * (occupied[:, :, None] & slab[None, None, :]).float()
    return out
