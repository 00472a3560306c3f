"""Cameras and rays of a render mix, from the seed.

A pose stands inside the room, above the boxes, at a yaw drawn uniformly and
a downward pitch drawn from the mix's range, with no roll. Pixels are a
pinhole grid of the mix's size and horizontal field of view (square
pixels, principal point at the centre). Rays have the program's 8-float
layout: origin, unit direction, near 0.01 and far the unit-sphere exit, as
the scene readers write them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEAR = 0.01


def poses(mix: dict, boxes: dict, seed: int, call: int) -> np.ndarray:
    """[frames, 4, 4] camera-to-world matrices of call ``call``."""
    rng = np.random.default_rng([int(seed), 0x43414D, int(call)])
    cam = mix["camera"]
    room = mix["room"]
    n = mix["frames_per_call"]
    hx, hy = room["half_xy"]
    m = cam["wall_gap"]
    zlo = max(float(boxes["tops"].max()) + cam["above_boxes"], cam["z"][0])
    pos = np.stack([rng.uniform(-hx + m, hx - m, n),
                    rng.uniform(-hy + m, hy - m, n),
                    rng.uniform(zlo, max(zlo, cam["z"][1]), n)], axis=1)
    yaw = rng.uniform(0.0, 2 * math.pi, n)
    pitch = np.radians(rng.uniform(*cam["pitch_deg"], n))
    fwd = np.stack([np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw),
                    np.sin(pitch)], axis=1)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    down = np.cross(fwd, right)
    out = np.zeros((n, 4, 4))
    out[:, :3, 0], out[:, :3, 1], out[:, :3, 2] = right, down, fwd
    out[:, :3, 3] = pos
    out[:, 3, 3] = 1.0
    return out.astype(np.float32)


def rays(mix: dict, c2w: np.ndarray, device) -> torch.Tensor:
    """[frames, H*W, 8] rays of the poses ``c2w``, made on ``device``."""
    h, w = mix["height"], mix["width"]
    f = (w / 2) / math.tan(math.radians(mix["hfov_deg"]) / 2)
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    cam = torch.stack([(i - (w - 1) / 2) / f, (j - (h - 1) / 2) / f,
                       torch.ones_like(i)], -1).reshape(-1, 3)
    m = torch.as_tensor(c2w, device=device)
    d = torch.einsum("pk,njk->npj", cam, m[:, :3, :3])
    return _with_bounds(m[:, None, :3, 3].expand_as(d), d)


def pixel_rays(mix: dict, m: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
               o: torch.Tensor) -> torch.Tensor:
    """[N, 8] rays of pixels (``i`` column, ``j`` row) of cameras with
    rotations ``m`` [N,3,3] at origins ``o`` [N,3], as ``rays`` makes them."""
    h, w = mix["height"], mix["width"]
    f = (w / 2) / math.tan(math.radians(mix["hfov_deg"]) / 2)
    cam = torch.stack([(i - (w - 1) / 2) / f, (j - (h - 1) / 2) / f,
                       torch.ones_like(i)], -1)
    return _with_bounds(o, torch.einsum("nk,njk->nj", cam, m))


def _with_bounds(o, d):
    """Rays of origins ``o`` along ``d`` (normalised here): near ``NEAR``,
    far the unit-sphere exit."""
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    od = torch.sum(o * d, -1)
    far = torch.sqrt(od ** 2 + (1.0 - torch.sum(o * o, -1))) - od
    near = torch.full_like(far, NEAR)
    return torch.cat([o, d, near[..., None], far[..., None]], -1).contiguous()
