"""Homogeneous-transform helpers.

Port of ``contrastive_lift_tpu/utils/transforms.py``: each helper takes
numpy arrays or torch tensors and returns the kind it was given (float32),
where the JAX one takes numpy or jax arrays. ``trs_comp`` composes on the
host in float64, as the JAX one does.
"""
from __future__ import annotations

import numpy as np
import torch


def hmg(mat3):
    """3x3 -> 4x4 homogeneous."""
    if isinstance(mat3, torch.Tensor):
        out = torch.eye(4, dtype=torch.float32, device=mat3.device)
        out[:3, :3] = mat3
        return out
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = mat3
    return out


def trs_comp(translation, rotation, scale):
    """Compose T @ R @ S into one 4x4 (numpy float32)."""
    t = np.eye(4, dtype=np.float64)
    t[:3, 3] = np.asarray(translation, np.float64)
    r = np.eye(4, dtype=np.float64)
    r[:3, :3] = np.asarray(rotation, np.float64)
    s = np.eye(4, dtype=np.float64)
    s[:3, :3] *= np.asarray(scale, np.float64)
    return (t @ r @ s).astype(np.float32)


def tr_comp(translation, rotation):
    return trs_comp(translation, rotation, 1.0)


def dot(transform, points):
    """Apply a 3x3/3x4/4x4 transform to [N,3] points; a torch tensor in
    either argument gives a tensor (on the points' device)."""
    if isinstance(points, torch.Tensor) or isinstance(transform, torch.Tensor):
        dev = (points.device if isinstance(points, torch.Tensor)
               else transform.device)
        transform = torch.as_tensor(transform, device=dev)
        points = torch.as_tensor(points, device=dev)
        if transform.shape == (3, 3):
            return points @ transform.T
        pts_h = torch.cat([points, torch.ones_like(points[:, :1])], dim=-1)
        return (pts_h @ transform.T)[:, :3]
    transform = np.asarray(transform)
    points = np.asarray(points)
    if transform.shape == (3, 3):
        return points @ transform.T
    pts_h = np.concatenate([points, np.ones_like(points[:, :1])], axis=-1)
    return (pts_h @ transform.T)[:, :3]


def inverse_rigid(transform):
    """Fast inverse of a rigid 4x4 (R|t)."""
    rot = transform[:3, :3]
    t = transform[:3, 3]
    if isinstance(transform, torch.Tensor):
        inv = torch.eye(4, dtype=transform.dtype, device=transform.device)
    else:
        inv = np.eye(4, dtype=transform.dtype)
    inv[:3, :3] = rot.T
    inv[:3, 3] = -rot.T @ t
    return inv
