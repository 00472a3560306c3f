"""Plain PyTorch and NumPy reference of Panoptic Lifting's training step.

The shared step (``reference/train.py``) with Panoptic Lifting's instance
loss in place of the slow-fast one (Siddiqui et al., "Panoptic Lifting for
3D Scene Understanding with Neural Fields", 2023, arXiv:2212.09802; the
reference trainer's ``create_virtual_gt_with_linear_assignment``). For
each instance image, the fast head's 500 logits at the bundle's rays are
matched to the image's labels: a cost of minus each label's mean softmax
mass in each channel, solved by the Hungarian method; then cross entropy
against each ray's matched channel, weighted by its confidence, and 0 where
every valid ray's argmax is already its match. There is no slow head and
no EMA.

Departures from the published loss, each the program's as well:
- the cost composites logits, as the JAX package does: the softmax is of
  the weighted sum of the samples' logits along the ray;
- a label's mean divides by its count plus 1e-4, and the rows of absent
  labels (up to ``max_labels_per_image``) cost 1e6;
- labels past ``max_labels_per_image`` share the last row (the sampler's
  folding).

The solve is this file's own (``hungarian``, float64, NumPy alone). With
seeded weights the 500 channels are nearly uniform, so two matches can lie
within rounding of each other: where the step is given the program's match
of an image (``follow``) and that match costs, on this step's own cost,
within ``BAND`` of the optimum's magnitude more than the optimum
(``excess``), the step replays it; otherwise it takes its own optimum.
"""
from __future__ import annotations

import numpy as np
import torch

from .train import *  # noqa: F401,F403
from .train import Step as SharedStep
from .train import _ce, _composite, _live_heads, mlp

# a match whose total cost lies within this share of the optimum's magnitude
# above the optimum ties it to rounding (``checks/mos.train_fixed.json``'s
# ``assign_excess`` limit)
BAND = 1e-6
# the cost of an absent label's row
ABSENT = 1e6


def hungarian(cost: np.ndarray) -> np.ndarray:
    """The assigned column of each row of ``cost`` [n, m] (n <= m) at the
    least total cost: shortest augmenting paths with dual potentials
    (Jonker-Volgenant, in the form of Crouse 2016, "On implementing 2D
    rectangular assignment algorithms"), one row at a time. Ties between
    columns go as in scipy's ``linear_sum_assignment``."""
    cost = np.asarray(cost, np.float64)
    nr, nc = cost.shape
    if nr > nc:
        raise ValueError(f"needs rows <= columns, got {cost.shape}")
    if not np.isfinite(cost).all():
        raise ValueError("cost has a NaN or an infinity")
    u, v = np.zeros(nr), np.zeros(nc)
    col4row = np.full(nr, -1, np.int64)
    row4col = np.full(nc, -1, np.int64)
    path = np.full(nc, -1, np.int64)
    for cur in range(nr):
        # the columns not yet on the path, in the order they are scanned
        remaining = np.arange(nc - 1, -1, -1)
        n_rem = nc
        spc = np.full(nc, np.inf)
        in_sr = np.zeros(nr, bool)
        in_sc = np.zeros(nc, bool)
        min_val, i, sink = 0.0, cur, -1
        while sink < 0:
            in_sr[i] = True
            rem = remaining[:n_rem]
            r = min_val + cost[i, rem] - u[i] - v[rem]
            better = r < spc[rem]
            path[rem[better]] = i
            spc[rem] = np.where(better, r, spc[rem])
            lowest = spc[rem].min()
            # the last free column at the least cost, else the first
            at = np.flatnonzero(spc[rem] == lowest)
            free = at[row4col[rem[at]] < 0]
            index = free[-1] if free.size else at[0]
            min_val = lowest
            j = rem[index]
            if row4col[j] < 0:
                sink = j
            else:
                i = row4col[j]
            in_sc[j] = True
            n_rem -= 1
            remaining[index] = remaining[n_rem]
        u[cur] += min_val
        others = in_sr.copy()
        others[cur] = False
        u[others] += min_val - spc[col4row[others]]
        v[in_sc] -= min_val - spc[in_sc]
        j = sink
        while True:
            i = path[j]
            row4col[j] = i
            col4row[i], j = j, col4row[i]
            if i == cur:
                break
    return col4row


def excess(cost: np.ndarray, match, optimum=None) -> float:
    """How much more ``match`` costs on the present labels' rows of
    ``cost`` than the optimum (``hungarian(cost)`` unless given), over the
    optimum's magnitude; infinite where ``match`` gives two present labels
    one channel. 0 without a present label."""
    rows = np.flatnonzero(cost[:, 0] < ABSENT)
    if rows.size == 0:
        return 0.0
    cols = np.asarray(match)[rows]
    if np.unique(cols).size < cols.size:
        return float("inf")
    if optimum is None:
        optimum = hungarian(cost)
    best = cost[rows, optimum[rows]].sum()
    return float((cost[rows, cols].sum() - best) / max(abs(best), 1e-30))


def assignment_cost(logits, labels, valid, num_labels: int) -> np.ndarray:
    """[num_labels, channels] float64: minus each label's mean softmax mass
    in each channel over the valid rays, ``ABSENT`` on the rows of labels
    that no valid ray has."""
    vf = valid.to(logits.dtype)
    with torch.no_grad():
        probs = torch.softmax(logits, -1) * vf[:, None]
        sums = torch.zeros(num_labels, logits.shape[1], dtype=logits.dtype,
                           device=logits.device).index_add(0, labels, probs)
        counts = torch.zeros(num_labels, dtype=logits.dtype,
                             device=logits.device).index_add(0, labels, vf)
        cost = torch.where((counts > 0)[:, None],
                           -(sums / (counts[:, None] + 1e-4)), ABSENT)
    return cost.double().cpu().numpy()


def assignment_loss(logits, labels, conf, valid, match):
    """The confidence-weighted cross entropy of each valid ray against its
    label's matched channel, over the valid rays; 0 (a tensor on the
    logits' graph) where every valid ray's argmax is already that
    channel."""
    target = torch.as_tensor(match, device=logits.device)[labels]
    vf = valid.to(logits.dtype)
    ones = torch.ones(logits.shape[1], dtype=logits.dtype,
                      device=logits.device)
    per = _ce(logits, target, ones) * conf * vf
    mismatch = ((logits.argmax(-1) != target) & valid).any()
    return torch.where(mismatch, per.sum() / vf.sum().clamp(min=1.0), 0.0)


class Step(SharedStep):
    """The shared step with the linear-assignment instance loss.
    ``follow``: per instance image, the program's match to replay where it
    lies within ``BAND``, or None. After a run ``assigned`` holds, per image,
    (the cost it solved [labels, channels] in float64, its optimum, the
    match it used)."""

    follow = None

    def instance_loss(self, params, batch, jitter):
        loss = 0.0
        layers = params["instance_mlp"]["fast"]["layers"]
        self.assigned = []
        for k in range(batch["rays"].shape[0]):
            rays = batch["rays"][k]
            w, xyz_n = self.aux_weights(params, rays, jitter[k])
            r, wl, p = _live_heads(w, xyz_n,
                                   self.model["raymarch_weight_thres"])
            logits = _composite(rays.shape[0], r, wl,
                                mlp(layers, p, self.dtype))
            labels, valid = batch["labels"][k].long(), batch["valid"][k]
            cost = assignment_cost(logits, labels, valid,
                                   self.cfg["max_labels_per_image"])
            optimum = match = hungarian(cost)
            if (self.follow is not None
                    and excess(cost, self.follow[k], optimum) <= BAND):
                match = np.asarray(self.follow[k])
            self.assigned.append((cost, optimum, match))
            loss = loss + assignment_loss(logits, labels,
                                          batch["confidences"][k], valid,
                                          match)
        return loss
