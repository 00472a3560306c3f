"""Plain PyTorch reference render of a TensoRF panoptic field.

Imports nothing of the program. It reads the parameter tree the benchmark
drew (VM factors, basis, MLP weights) and the rays, and renders every
sample densely: AABB-clipped uniform samples at the configuration's step,
density from the VM factors by bilinear (plane) times linear (line)
interpolation with align-corners coordinates and zeros outside, softplus
after the -10 shift, alpha = 1 - exp(-sigma * step * 25), exclusive
transmittance, and the heads at every sample whose weight exceeds the
threshold (1e-4): rgb from the appearance MLP on [features, viewdir,
PE(features), PE(viewdir)] through a sigmoid, class probabilities from the
semantic MLP on xyz through a softmax, normalised over the ray and logged,
instance embeddings from the instance MLPs on xyz (fast then slow). Depth is
the weighted sum of the sample distances.

Every sample's interval is the step itself, the exact value (the
difference of two rounded distances carries a relative error of 1e-4 at
these steps). Matmuls run in float32 with TF32 off unless ``tf32`` (the
control) or ``head_dtype`` bfloat16 asks otherwise.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

MATRIX_MODE = ((0, 1), (0, 2), (1, 2))
VECTOR_MODE = (2, 1, 0)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def step_size(bounds: torch.Tensor, grid_dim, step_ratio: float) -> torch.Tensor:
    """The marching step: the mean voxel size (extent / (g - 1 + 1e-3),
    as the reference's renderer sizes it) times the step ratio, float32."""
    extent = bounds[1] - bounds[0]
    g = torch.tensor([float(x) for x in grid_dim], device=bounds.device)
    units = extent / (g - 1 + 1e-3)
    return torch.sum(units) * (1.0 / 3.0) * step_ratio


def n_samples(bounds, grid_dim, step_ratio: float) -> int:
    """Samples per ray: the box diagonal over the step, plus one (float32
    units, as the reference's renderer counts them)."""
    extent = np.asarray(bounds, np.float32)
    extent = extent[1] - extent[0]
    units = extent / (np.asarray(grid_dim, np.float32) - 1 + 1e-3)
    step = float(np.mean(units) * step_ratio)
    return int(float(np.sqrt(np.sum(extent ** 2))) / step) + 1


def _interp_axis(coord: torch.Tensor, size: int):
    """Align-corners pixel of [-1, 1] coords: (lower index, upper index,
    weight of the upper, lower valid, upper valid)."""
    p = (coord + 1.0) * 0.5 * (size - 1)
    i0 = torch.floor(p)
    w1 = p - i0
    i0 = i0.to(torch.int64)
    i1 = i0 + 1
    return (i0, i1, w1, (i0 >= 0) & (i0 < size), (i1 >= 0) & (i1 < size))


def _gather_plane(plane: torch.Tensor, iy, ix, ok) -> torch.Tensor:
    """[C, H, W] at integer pixels -> [P, C], zero where not ``ok``."""
    C, H, W = plane.shape
    flat = plane.reshape(C, H * W)
    idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1))
    return flat[:, idx].t() * ok[:, None]


def plane_bilinear(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """[C, H, W] plane at coords (u indexes W, v indexes H) -> [P, C]."""
    C, H, W = plane.shape
    x0, x1, wx, okx0, okx1 = _interp_axis(u, W)
    y0, y1, wy, oky0, oky1 = _interp_axis(v, H)
    wx, wy = wx[:, None], wy[:, None]
    return ((1 - wx) * (1 - wy) * _gather_plane(plane, y0, x0, okx0 & oky0)
            + wx * (1 - wy) * _gather_plane(plane, y0, x1, okx1 & oky0)
            + (1 - wx) * wy * _gather_plane(plane, y1, x0, okx0 & oky1)
            + wx * wy * _gather_plane(plane, y1, x1, okx1 & oky1))


def line_linear(line: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[C, L] line at coords t -> [P, C]."""
    C, L = line.shape
    i0, i1, w1, ok0, ok1 = _interp_axis(t, L)
    w1 = w1[:, None]
    a = line[:, i0.clamp(0, L - 1)].t() * ok0[:, None]
    b = line[:, i1.clamp(0, L - 1)].t() * ok1[:, None]
    return (1 - w1) * a + w1 * b


def vm_terms(factors: dict, xyz: torch.Tensor):
    """The per-axis plane * line products [P, C_i], i = 0, 1, 2."""
    out = []
    for i in range(3):
        m0, m1 = MATRIX_MODE[i]
        p = plane_bilinear(factors["planes"][i], xyz[:, m0], xyz[:, m1])
        out.append(p * line_linear(factors["lines"][i], xyz[:, VECTOR_MODE[i]]))
    return out


def mlp(layers, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    h = x.to(dtype)
    for i, layer in enumerate(layers):
        h = h @ layer["w"].to(dtype) + layer["b"].to(dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    # a bfloat16 head's output comes back in float32; float64 stays
    return h.to(torch.promote_types(dtype, torch.float32))


def positional_encoding(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """[P, D] -> [P, 2 freqs D]: sin then cos of x_d 2^k, k fastest."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[:, :, None] * bands).reshape(x.shape[0], -1)
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def render(params: dict, model: dict, rays: torch.Tensor, bounds, grid_dim,
           step_ratio: float, block: int = 512, tf32: bool = False,
           head_dtype=torch.float32) -> dict:
    """Maps of ``rays`` [N, 8] (origin, unit direction, near, far):
    ``rgb`` [N, 3], ``depth`` [N], ``semantics`` [N, C] (log of the
    normalised probabilities), ``instances`` [N, D], and per ray the
    counts ``in_box`` and ``heads`` (samples above the weight threshold)."""
    bounds = torch.as_tensor(bounds, dtype=torch.float32, device=rays.device)
    step = step_size(bounds, grid_dim, step_ratio)
    S = n_samples(bounds.cpu().numpy(), grid_dim, step_ratio)
    thres = model["raymarch_weight_thres"]
    shift = model["splus_density_shift"]
    scale = model["distance_scale"]
    inv_extent = 2.0 / (bounds[1] - bounds[0])
    out = {k: [] for k in ("rgb", "depth", "semantics", "instances",
                           "in_box", "heads")}
    ladder = torch.arange(S, dtype=torch.float32, device=rays.device)
    with torch.no_grad(), matmul_precision(tf32):
        for r0 in range(0, rays.shape[0], block):
            r = rays[r0:r0 + block]
            o, d, near, far = r[:, 0:3], r[:, 3:6], r[:, 6], r[:, 7]
            vec = torch.where(d == 0, torch.full_like(d, 1e-6), d)
            t_in = torch.amax(torch.minimum((bounds[1] - o) / vec,
                                            (bounds[0] - o) / vec), dim=-1)
            t_in = torch.minimum(torch.maximum(t_in, near), far)
            z = t_in[:, None] + ladder[None, :] * step            # [B, S]
            xyz = o[:, None, :] + d[:, None, :] * z[..., None]
            in_box = torch.all((xyz >= bounds[0]) & (xyz <= bounds[1]), -1)
            xyz_n = ((xyz - bounds[0]) * inv_extent - 1.0).reshape(-1, 3)
            raw = sum(t.sum(-1) for t in vm_terms(params["density"], xyz_n))
            sigma = torch.logaddexp(raw + shift, torch.zeros_like(raw))
            sigma = torch.where(in_box, sigma.reshape(z.shape), 0.0)
            alpha = 1.0 - torch.exp(-sigma * step * scale)
            trans = torch.cumprod(torch.cat(
                [torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)
            weight = alpha * trans[:, :-1]                        # [B, S]
            live = weight > thres
            ray_i, smp_i = torch.nonzero(live, as_tuple=True)
            w = weight[ray_i, smp_i][:, None]
            p = xyz_n.reshape(*z.shape, 3)[ray_i, smp_i]          # [H, 3]
            feats = torch.cat(vm_terms(params["appearance"], p), -1)
            feats = feats @ params["appearance_basis"]["w"]
            view = d[ray_i]
            app_in = torch.cat([feats, view,
                                positional_encoding(feats, model["pe_feat"]),
                                positional_encoding(view, model["pe_view"])], -1)
            rgb = torch.sigmoid(mlp(params["appearance_mlp"]["layers"], app_in,
                                    head_dtype))
            sem = mlp(params["semantic_mlp"]["layers"], p, head_dtype)
            if model["semantic_softmax"]:
                sem = torch.softmax(sem, -1)
            ins = torch.cat([mlp(params["instance_mlp"][h]["layers"], p,
                                 head_dtype)
                             for h in model["instance_heads"]], -1)
            B = r.shape[0]

            def composite(vals):
                acc = torch.zeros(B, vals.shape[1], device=r.device)
                return acc.index_add_(0, ray_i, w * vals)

            rgb_map = torch.clamp(composite(rgb), 0.0, 1.0)
            sem_map = composite(sem)
            sem_map = torch.log(sem_map / (sem_map.sum(-1, keepdim=True)
                                           + 1e-8) + 1e-8)
            out["rgb"].append(rgb_map)
            out["semantics"].append(sem_map)
            out["instances"].append(composite(ins))
            out["depth"].append(torch.sum(weight * z, -1))
            out["in_box"].append(in_box.sum(-1))
            out["heads"].append(live.sum(-1))
    return {k: torch.cat(v) for k, v in out.items()}
