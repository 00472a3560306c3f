"""Flat-kernel mean-shift (sklearn-compatible) with the distance work on the device.

Port of ``contrastive_lift_tpu/ops/meanshift.py``. Bin seeding and mode
dedup stay on the host in numpy; the seed shifts and nearest-center labels
are torch matmuls on the device. The semantics match sklearn's
``MeanShift(bin_seeding=True, cluster_all=False)`` and the JAX class:

  * seeds = centers of bandwidth-sized bins holding >= min_bin_freq points;
  * each block of 256 seeds iterates mean-of-neighbors-within-bandwidth until
    the block's largest shift is < 1e-3 * bandwidth (or max_iter);
  * modes sorted by window population, deduped within bandwidth (greedy);
  * fit labels: nearest center if within bandwidth else -1;
  * predict labels: nearest center, no radius check.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


def silverman_bandwidth(n: int, d: int) -> float:
    """scipy.stats.gaussian_kde(..., 'silverman').covariance_factor()."""
    return (n * (d + 2) / 4.0) ** (-1.0 / (d + 4))


def bin_seeds(points: np.ndarray, bin_size: float, min_bin_freq: int = 1) -> np.ndarray:
    """Histogram seeding on a bandwidth-sized lattice (host-side numpy)."""
    binned = np.round(points / bin_size)
    uniq, counts = np.unique(binned, axis=0, return_counts=True)
    seeds = uniq[counts >= min_bin_freq] * bin_size
    if len(seeds) == len(points) or len(seeds) == 0:
        return points.astype(np.float32)
    return seeds.astype(np.float32)


def _dist2(points, pt_sq, s):
    """[B, N] squared distances via matmul: |p|^2 - 2 s.p + |s|^2."""
    cross = s @ points.T
    s_sq = torch.sum(s * s, dim=1, keepdim=True)
    return pt_sq[None, :] - 2.0 * cross + s_sq


def _shift_seeds(points: torch.Tensor, seeds: torch.Tensor, bandwidth: float,
                 max_iter: int = 300, block: int = 256):
    """Iterate all seeds to their modes. Returns (modes [S,d], n_within [S]).

    Seeds run in blocks of ``block``; a block stops when its largest shift
    falls below 1e-3 * bandwidth, as in the JAX while-loop."""
    bw = np.float32(bandwidth)
    bw2 = float(bw * bw)
    stop_thresh = float(np.float32(1e-3) * bw)
    n_seeds = seeds.shape[0]
    pad = (-n_seeds) % block
    seeds_p = torch.nn.functional.pad(seeds, (0, 0, 0, pad))
    pt_sq = torch.sum(points * points, dim=1)
    modes, n_within = [], []
    for s in seeds_p.split(block):
        shift, it = float("inf"), 0
        while it < max_iter and shift >= stop_thresh:
            within = (_dist2(points, pt_sq, s) <= bw2).to(points.dtype)
            counts = torch.sum(within, dim=1, keepdim=True)
            new_s = (within @ points) / torch.clamp(counts, min=1.0)
            new_s = torch.where(counts > 0, new_s, s)
            shift = float(torch.max(torch.linalg.norm(new_s - s, dim=1)))
            s = new_s
            it += 1
        modes.append(s)
        n_within.append(torch.sum(_dist2(points, pt_sq, s) <= bw2, dim=1))
    return torch.cat(modes)[:n_seeds], torch.cat(n_within)[:n_seeds]


def _nearest_center(points: torch.Tensor, centers: torch.Tensor,
                    bandwidth: float, within_only: bool = False) -> torch.Tensor:
    """Label each point with its nearest center (optionally -1 outside bw)."""
    cross = points @ centers.T
    d2 = (torch.sum(points * points, 1)[:, None] - 2 * cross
          + torch.sum(centers * centers, 1)[None, :])
    labels = torch.argmin(d2, dim=1).to(torch.int32)
    if within_only:
        bw = np.float32(bandwidth)
        best = torch.gather(d2, 1, labels[:, None].long())[:, 0]
        labels = torch.where(best <= float(bw * bw), labels,
                             torch.full_like(labels, -1))
    return labels


class MeanShift:
    """Functional equivalent of sklearn MeanShift for this pipeline, with the
    distance work on ``device``."""

    def __init__(self, bandwidth: float, bin_seeding: bool = True,
                 min_bin_freq: int = 10, cluster_all: bool = False,
                 max_iter: int = 300, device="cuda"):
        self.bandwidth = float(bandwidth)
        self.bin_seeding = bin_seeding
        self.min_bin_freq = min_bin_freq
        self.cluster_all = cluster_all
        self.max_iter = max_iter
        self.device = resolve_device(device)
        self.cluster_centers_: np.ndarray | None = None
        self.labels_: np.ndarray | None = None

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def fit(self, X: np.ndarray) -> "MeanShift":
        X = np.asarray(X, np.float32)
        seeds = (bin_seeds(X, self.bandwidth, self.min_bin_freq)
                 if self.bin_seeding else X)
        points = self._tensor(X)
        modes, n_within = _shift_seeds(points, self._tensor(seeds),
                                       self.bandwidth, self.max_iter)
        modes = modes.cpu().numpy()
        n_within = n_within.cpu().numpy()
        keep = n_within > 0
        modes, n_within = modes[keep], n_within[keep]
        if len(modes) == 0:
            raise ValueError("No point was within bandwidth of any seed.")
        # dedup modes within bandwidth, richest window first (sklearn order)
        order = np.argsort(-n_within, kind="stable")
        modes = modes[order]
        unique = np.ones(len(modes), bool)
        for i in range(len(modes)):
            if unique[i]:
                d = np.linalg.norm(modes - modes[i], axis=1)
                unique &= ~((d < self.bandwidth) & (np.arange(len(modes)) > i))
        self.cluster_centers_ = modes[unique]
        self.labels_ = _nearest_center(
            points, self._tensor(self.cluster_centers_), self.bandwidth,
            within_only=not self.cluster_all).cpu().numpy()
        return self

    def predict(self, X: np.ndarray, chunk: int = 4_000_000) -> np.ndarray:
        if self.cluster_centers_ is None:
            raise RuntimeError("MeanShift.predict before fit")
        X = np.asarray(X, np.float32)
        out = np.empty(len(X), np.int32)
        centers = self._tensor(self.cluster_centers_)
        for i in range(0, len(X), chunk):
            out[i:i + chunk] = _nearest_center(
                self._tensor(X[i:i + chunk]), centers,
                self.bandwidth).cpu().numpy()
        return out
