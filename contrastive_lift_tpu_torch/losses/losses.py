"""Training losses: TV, (symmetric) cross-entropy, segment grouping,
contrastive, slow-fast and linear assignment.

Port of ``contrastive_lift_tpu/losses/losses.py``: the same static-shape
formulations (per-label reductions over a fixed label capacity with validity
masks), in PyTorch. ``linear_assignment_loss`` solves its assignment on the
host with ``scipy.optimize.linear_sum_assignment``, the solver the reference
called, inside the span ``train.assign`` (the cost's copy to the host, the
solve and the match's copy back), with the counters ``assign.rows`` (the
labels present) and ``assign.slots`` (the rows solved).

The batch means take an optional ``count``: a rank of a data-parallel step
passes the global batch's count, so that its loss is its share of the
global mean (``train/step.py``); by default the mean is over the local
batch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.observability import count, span


def _segment_sum(values: torch.Tensor, ids: torch.Tensor,
                 num: int) -> torch.Tensor:
    """sum of ``values`` [N, ...] per id in [0, num): [num, ...]."""
    out = torch.zeros((num,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add(0, ids.to(torch.int64), values)


# ---------------------------------------------------------------------------
# Simple regression / regularizer losses
# ---------------------------------------------------------------------------

def _mean(x: torch.Tensor, count=None) -> torch.Tensor:
    """The mean of ``x``, or its sum over ``count`` when given."""
    return torch.mean(x) if count is None else torch.sum(x) / count


def mse_loss(pred, target, count=None):
    return _mean((pred - target) ** 2, count)


def l1_loss(pred, target, count=None):
    return _mean(torch.abs(pred - target), count)


def tv_loss_2d(x: torch.Tensor) -> torch.Tensor:
    """Total variation of a [C, H, W] factor plane:
    2 * (h_tv / count_h + w_tv / count_w), the reference TVLoss."""
    c, h, w = x.shape
    count_h = c * (h - 1) * w + 1e-4
    count_w = c * h * (w - 1) + 1e-4
    h_tv = torch.sum((x[:, 1:, :] - x[:, :-1, :]) ** 2)
    w_tv = torch.sum((x[:, :, 1:] - x[:, :, :-1]) ** 2)
    return 2.0 * (h_tv / count_h + w_tv / count_w)


def tv_loss_1d(x: torch.Tensor) -> torch.Tensor:
    """TV of a [C, L] factor line (only the L direction contributes)."""
    c, l = x.shape
    count_h = c * (l - 1) + 1e-4
    return 2.0 * (torch.sum((x[:, 1:] - x[:, :-1]) ** 2) / count_h)


def branch_tv(params: dict, name: str, plane_scale: float,
              line_scale: float) -> torch.Tensor:
    """Plane (and, with ``line_scale``, line) TV of one grid branch; 0 when
    the model has no such branch."""
    grid = params.get(name)
    if grid is None:
        return torch.zeros(())
    total = 0.0
    for plane in grid["planes"]:
        total = total + tv_loss_2d(plane) * plane_scale
    if line_scale > 0:
        for line in grid["lines"]:
            total = total + tv_loss_1d(line) * line_scale
    return total


def total_tv_loss(params: dict, cfg, epoch: int) -> torch.Tensor:
    """Epoch-gated weighted TV over all branches."""
    loss = branch_tv(params, "density", 1e-2, 0.0) * cfg.lambda_tv_density
    loss = loss + branch_tv(params, "appearance", 1e-2, 0.0) * cfg.lambda_tv_appearance
    if epoch >= cfg.late_semantic_optimization:
        loss = loss + branch_tv(params, "semantic", 1e-2, 1e-3) * cfg.lambda_tv_semantics
    if epoch >= cfg.instance_optimization_epoch:
        loss = loss + branch_tv(params, "instance", 1e-2, 1e-3) * cfg.lambda_tv_instances
    return loss


# ---------------------------------------------------------------------------
# Semantic losses
# ---------------------------------------------------------------------------

def get_semantic_weights(reweight_fg: bool, fg_classes, num_classes: int,
                         weight_class_0: float = 0.0,
                         device="cuda") -> torch.Tensor:
    """Per-class CE weights: 2 on foreground classes when ``reweight_fg``,
    ``weight_class_0`` on class 0, else 1."""
    weights = torch.ones(num_classes, dtype=torch.float32)
    if reweight_fg:
        weights[torch.as_tensor(list(fg_classes), dtype=torch.int64)] = 2.0
    weights[0] = weight_class_0
    return weights.to(resolve_device(device))


def weighted_ce_with_logits(logits, target, class_weights=None):
    """Per-example weighted cross entropy with torch.nn.CrossEntropyLoss
    semantics (reduction 'none'); ``target`` int labels [N] or
    probabilities [N, C]."""
    logp = torch.log_softmax(logits, dim=-1)
    if target.ndim == logits.ndim:
        if class_weights is not None:
            logp = logp * class_weights[None, :]
        return -torch.sum(target * logp, dim=-1)
    target = target.to(torch.int64)
    picked = torch.gather(logp, 1, target[:, None])[:, 0]
    if class_weights is not None:
        picked = picked * class_weights[target]
    return -picked


def sce_loss(logits, target_probs, alpha: float, beta: float, class_weights):
    """Symmetric cross entropy: alpha * CE + beta * reverse CE."""
    ce = weighted_ce_with_logits(logits, target_probs, class_weights)
    pred = torch.softmax(logits * class_weights[None, :], dim=-1)
    pred = torch.clamp(pred, 1e-8, 1.0)
    labels = torch.clamp(target_probs, 1e-8, 1.0)
    rce = torch.sum(-pred * torch.log(labels) * class_weights[None, :], dim=-1)
    return alpha * ce + beta * rce


def semantic_loss(logits, semantics, probs, confs, mode: str, class_weights,
                  use_symmetric: bool = False, ce_alpha: float = 0.85,
                  ce_beta: float = 0.15, count=None):
    """The three supervision modes: probability targets with confidence
    (TTAConf), label targets with confidence (NoTTAConf), plain labels;
    averaged over ``count`` rays (default: these)."""
    if use_symmetric:
        per = sce_loss(logits, probs, ce_alpha, ce_beta, class_weights)
        return _mean(per * confs, count)
    if mode == "TTAConf":
        return _mean(weighted_ce_with_logits(logits, probs, class_weights)
                     * confs, count)
    if mode == "NoTTAConf":
        return _mean(weighted_ce_with_logits(logits, semantics,
                                             class_weights) * confs, count)
    return _mean(weighted_ce_with_logits(logits, semantics, class_weights),
                 count)


# ---------------------------------------------------------------------------
# Segment-grouping loss
# ---------------------------------------------------------------------------

def segment_grouping_loss(sem_features, group_ids, confidences, num_groups: int,
                          class_weights, mode: str = "argmax_conf",
                          valid: Optional[torch.Tensor] = None,
                          count=None):
    """Pull each ray toward the argmax of its 2D segment's mean logits:
    weighted CE against that target, times the confidence in the ``*_conf``
    modes, averaged over valid rays (``count`` of them, default these)."""
    if valid is None:
        valid = torch.ones(sem_features.shape[0], dtype=torch.bool,
                           device=sem_features.device)
    vf = valid.to(sem_features.dtype)
    sums = _segment_sum(sem_features * vf[:, None], group_ids, num_groups)
    counts = _segment_sum(vf, group_ids, num_groups)
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    target = torch.argmax(means, dim=-1)[group_ids.to(torch.int64)]
    per = weighted_ce_with_logits(sem_features, target, class_weights)
    if "conf" in mode and not mode.endswith("noconf"):
        per = per * confidences
    per = per * vf
    if count is None:
        count = torch.sum(vf)
    return torch.sum(per) / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------------------
# Vanilla contrastive loss
# ---------------------------------------------------------------------------

def contrastive_loss(features, instance_labels, temperature: float,
                     valid: Optional[torch.Tensor] = None):
    """Pairwise Euclidean contrastive loss; positive pairs (same label, off
    the diagonal) use ``temperature``, negatives 1."""
    n = features.shape[0]
    dev = features.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    same = instance_labels[:, None] == instance_labels[None, :]
    pair_valid = valid[:, None] & valid[None, :]
    masks = same & ~torch.eye(n, dtype=torch.bool, device=dev) & pair_valid
    diff = features[:, None, :] - features[None, :, :]
    distance_sq = torch.sum(diff * diff, dim=-1)
    temp = torch.where(masks, temperature, 1.0)
    logits = torch.exp(torch.exp(-distance_sq / temp)) * pair_valid
    p = torch.sum(logits * masks, dim=-1)
    z = torch.sum(logits, dim=-1)
    prob = p / torch.clamp(z, min=1e-12)
    keep = (prob > 0) & valid
    log_prob = torch.where(keep, torch.log(torch.clamp(prob, min=1e-12)), 0.0)
    return -torch.sum(log_prob) / torch.clamp(torch.sum(valid), min=1)


# ---------------------------------------------------------------------------
# Slow-fast contrastive loss
# ---------------------------------------------------------------------------

def slow_fast_loss(fast_proj, slow_proj, labels, confidences, num_labels: int,
                   valid: Optional[torch.Tensor] = None):
    """Slow-fast concentration + contrastive loss over one image's bundle.

    The first half of the rays are "fast", the second "slow" (``slow_proj``
    already without gradient). Concentration: over labels present in both
    halves, -mean over fast points of exp(-||fast - slow centroid||^2) *
    confidence. Contrastive: fast-vs-slow label match, sim = exp(-dist),
    -log(sum_pos exp(sim) / sum_all exp(sim)) over rows with a positive. A
    half without labels gives 0."""
    n = labels.shape[0]
    dev = fast_proj.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    labels = labels.to(torch.int64)
    idx = torch.arange(n, device=dev)
    fast_mask = (idx < n // 2) & valid
    slow_mask = (idx >= n // 2) & valid
    fm = fast_mask.to(fast_proj.dtype)
    sm = slow_mask.to(fast_proj.dtype)

    counts_fast = _segment_sum(fm, labels, num_labels)
    counts_slow = _segment_sum(sm, labels, num_labels)
    label_in_both = (counts_fast > 0) & (counts_slow > 0)
    num_intersecting = torch.sum(label_in_both)

    slow_sums = _segment_sum(slow_proj * sm[:, None], labels, num_labels)
    centroids = slow_sums / torch.clamp(counts_slow, min=1.0)[:, None]
    dist_sq = torch.sum((fast_proj - centroids[labels]) ** 2, dim=-1)
    point_term = torch.exp(-dist_sq / 1.0) * confidences * fm
    label_means = (_segment_sum(point_term, labels, num_labels)
                   / torch.clamp(counts_fast, min=1.0))
    conc_sum = torch.sum(torch.where(label_in_both, -label_means, 0.0))
    loss_conc = torch.where(num_intersecting > 0,
                            conc_sum / torch.clamp(num_intersecting, min=1),
                            0.0)

    pair_valid = fast_mask[:, None] & slow_mask[None, :]
    label_match = (labels[:, None] == labels[None, :]) & pair_valid
    diff = fast_proj[:, None, :] - slow_proj[None, :, :]
    cdist = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=1e-24))
    logits = torch.exp(torch.exp(-cdist / 1.0)) * pair_valid
    pos = torch.sum(logits * label_match, dim=-1)
    z = torch.sum(logits, dim=-1)
    prob = pos / torch.clamp(z, min=1e-12)
    keep = prob > 0
    n_keep = torch.clamp(torch.sum(keep), min=1)
    loss_contrast = -torch.sum(torch.where(
        keep, torch.log(torch.clamp(prob, min=1e-12)), 0.0)) / n_keep

    ok = (torch.sum(counts_fast) > 0) & (torch.sum(counts_slow) > 0)
    return torch.where(ok, loss_conc + loss_contrast, 0.0)


# ---------------------------------------------------------------------------
# Linear-assignment (Panoptic-Lifting baseline) loss
# ---------------------------------------------------------------------------

def hungarian(cost: np.ndarray) -> np.ndarray:
    """Min-cost rectangular assignment (n_rows <= n_cols): the assigned
    column of each row. The JAX package's ``_hungarian_jax`` is the same
    Jonker-Volgenant solve as scipy's; on exact ties an equally optimal
    permutation may differ."""
    from scipy.optimize import linear_sum_assignment
    cost = np.asarray(cost, np.float64)
    if cost.shape[0] > cost.shape[1]:
        raise ValueError(f"Hungarian requires n_rows <= n_cols, got {cost.shape}")
    rows, cols = linear_sum_assignment(cost)
    out = np.empty(cost.shape[0], np.int64)
    out[rows] = cols
    return out


def linear_assignment_loss(instance_logits, labels, confidences,
                           num_labels: int,
                           valid: Optional[torch.Tensor] = None):
    """Hungarian-matched virtual-GT cross entropy: labels are matched to
    prediction channels by mean softmax mass, then confidence-weighted CE
    against the matched channel; 0 when the predictions already agree."""
    n, c = instance_logits.shape
    dev = instance_logits.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    labels = labels.to(torch.int64)
    vf = valid.to(instance_logits.dtype)
    with torch.no_grad():
        probs = torch.softmax(instance_logits, dim=-1)
        sums = _segment_sum(probs * vf[:, None], labels, num_labels)
        counts = _segment_sum(vf, labels, num_labels)
        cost = -(sums / (counts[:, None] + 1e-4))
        cost = torch.where((counts > 0)[:, None], cost, 1e6)
        with span("train.assign"):
            host = cost.cpu().numpy()
            # a present label's row is a mean mass, in [-1, 0]
            count("assign.rows", int((host[:, 0] < 1e6).sum()))
            count("assign.slots", num_labels)
            assignment = torch.as_tensor(hungarian(host), device=dev)
    virtual_gt = assignment[labels]
    predicted = torch.argmax(instance_logits, dim=-1)
    any_mismatch = torch.any((virtual_gt != predicted) & valid)
    per = weighted_ce_with_logits(instance_logits, virtual_gt) * confidences * vf
    loss = torch.sum(per) / torch.clamp(torch.sum(vf), min=1.0)
    return torch.where(any_mismatch, loss, 0.0)
