"""Volume-rendering compositing primitives (alpha, transmittance, distortion).

Port of ``contrastive_lift_tpu/ops/compositing.py``; fp32 throughout.
"""
from __future__ import annotations

import torch


def raw_to_alpha(sigma: torch.Tensor, dist: torch.Tensor):
    """(alpha, weights, bg_weight) from density and scaled segment lengths.

    sigma, dist: [R, S]. alpha = 1-exp(-sigma*dist); T = cumprod(1-alpha+1e-10)
    shifted by one; weights = alpha*T."""
    sigma = sigma.to(torch.float32)
    dist = dist.to(torch.float32)
    alpha = 1.0 - torch.exp(-sigma * dist)
    ones = torch.ones((*alpha.shape[:-1], 1), dtype=alpha.dtype,
                      device=alpha.device)
    t = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1), dim=-1)
    weights = alpha * t[..., :-1]
    return alpha, weights, t[..., -1:]


def distortion_loss(weights: torch.Tensor, midpoints: torch.Tensor,
                    intervals: torch.Tensor) -> torch.Tensor:
    """Mip-NeRF-360 distortion regularizer, O(S) prefix-sum form.

    loss = mean_r[ sum_{i,j} w_i w_j |m_i - m_j| + (1/3) sum_i w_i^2 d_i ]"""
    w = weights.to(torch.float32)
    m = midpoints.to(torch.float32)
    loss_uni = (1.0 / 3.0) * torch.mean(torch.sum(w * w * intervals, dim=-1))
    wm = w * m
    w_cum = torch.cumsum(w, dim=-1)
    wm_cum = torch.cumsum(wm, dim=-1)
    loss_bi = 2.0 * torch.mean(torch.sum(
        wm[..., 1:] * w_cum[..., :-1] - w[..., 1:] * wm_cum[..., :-1], dim=-1))
    return loss_bi + loss_uni


def composite(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Weighted sum over the sample axis: [R,S],[R,S,C] -> [R,C]."""
    return torch.sum(weights[..., None] * values, dim=-2)
