"""Panoptic Quality (PQ / SQ / RQ) with robust-class filtering (the port's
copy of ``contrastive_lift_tpu/metrics/panoptic_quality.py``).

Host-side numpy implementation with identical matching semantics to the
reference's torchmetrics-derived version (reference: util/panoptic_quality.py):
(category, instance) color pairs, IoU > 0.5 matching with void subtraction,
FP/FN void-majority discards, per-category averaging. The quadratic
unique-color dictionaries become vectorized np.unique joins so cross-frame
"PQ^scene" tensors (all test frames concatenated) stay fast.
"""
from __future__ import annotations

from typing import Set, Tuple

import numpy as np


def _pack(cat: np.ndarray, inst: np.ndarray) -> np.ndarray:
    """Pack (category, instance) into one int64 key."""
    return cat.astype(np.int64) * np.int64(1 << 32) + inst.astype(np.int64)


def get_non_robust_classes_for_image(pred_sem, target_sem, robustness_thres=0.005) -> Set[int]:
    """Classes occupying <thres of pixels in either map (reference :217-222)."""
    out = set()
    for sem in (pred_sem, target_sem):
        uniq, counts = np.unique(sem, return_counts=True)
        perc = counts / counts.sum()
        out |= set(uniq[perc < robustness_thres].tolist())
    return out


def _preprocess(img: np.ndarray, things: Set[int], stuff: Set[int],
                void_pair: Tuple[int, int], allow_unknown: bool) -> np.ndarray:
    """Flatten to [N,2]; zero stuff instance ids; void unknown categories."""
    img = img.reshape(-1, 2).astype(np.int64).copy()
    cat = img[:, 0]
    stuff_pix = np.isin(cat, list(stuff))
    things_pix = np.isin(cat, list(things))
    img[stuff_pix, 1] = 0
    unknown = ~(stuff_pix | things_pix)
    if not allow_unknown and unknown.any():
        raise ValueError("Unknown categories found in preds")
    img[unknown] = void_pair
    return img


def panoptic_quality_match(preds, target, things: Set[int], stuff: Set[int],
                           allow_unknown_preds_category: bool = False,
                           robust: float = 0.005):
    """Raw PQ stats (things, stuff, iou_sum, tp, fp, fn) for aggregation.

    preds/target: [..., 2] int arrays of (semantic, instance).
    Reference: util/panoptic_quality.py:250-271.
    """
    preds = np.asarray(preds)
    target = np.asarray(target)
    assert preds.shape == target.shape
    present = set(np.unique(preds[..., 0]).tolist()) | set(np.unique(target[..., 0]).tolist())
    unused = (things | stuff) - present
    non_robust = get_non_robust_classes_for_image(preds[..., 0], target[..., 0], robust)
    things = set(things) - unused - non_robust
    stuff = set(stuff) - unused - non_robust
    assert not (things & stuff)

    void_cat = 1 + max([0] + list(things) + list(stuff))
    void_pair = (void_cat, 0)
    cat_order = list(things) + list(stuff)
    cat_to_cont = {c: i for i, c in enumerate(cat_order)}
    n_cat = len(cat_order)

    fp_img = _preprocess(preds, things, stuff, void_pair, allow_unknown_preds_category)
    ft_img = _preprocess(target, things, stuff, void_pair, True)

    pk = _pack(fp_img[:, 0], fp_img[:, 1])
    tk = _pack(ft_img[:, 0], ft_img[:, 1])
    void_key = _pack(np.asarray([void_pair[0]]), np.asarray([void_pair[1]]))[0]

    pred_keys, pred_inv, pred_areas = np.unique(pk, return_inverse=True, return_counts=True)
    tgt_keys, tgt_inv, tgt_areas = np.unique(tk, return_inverse=True, return_counts=True)

    # pairwise intersections via a joint key over (pred segment, target segment)
    joint = pred_inv.astype(np.int64) * len(tgt_keys) + tgt_inv
    joint_keys, joint_areas = np.unique(joint, return_counts=True)
    jp = (joint_keys // len(tgt_keys)).astype(np.int64)  # pred segment index
    jt = (joint_keys % len(tgt_keys)).astype(np.int64)   # target segment index

    # area of each pred segment overlapping void target, and vice versa
    pred_void_area = np.zeros(len(pred_keys), np.int64)
    void_tgt_area = np.zeros(len(tgt_keys), np.int64)
    tgt_is_void = tgt_keys[jt] == void_key
    np.add.at(pred_void_area, jp[tgt_is_void], joint_areas[tgt_is_void])
    pred_is_void = pred_keys[jp] == void_key
    np.add.at(void_tgt_area, jt[pred_is_void], joint_areas[pred_is_void])

    iou_sum = np.zeros(n_cat, np.float64)
    tp = np.zeros(n_cat, np.int64)
    fp = np.zeros(n_cat, np.int64)
    fn = np.zeros(n_cat, np.int64)

    pred_cat = (pred_keys >> 32).astype(np.int64)
    tgt_cat = (tgt_keys >> 32).astype(np.int64)

    # candidate matches: same category, target not void
    same_cat = (pred_cat[jp] == tgt_cat[jt]) & (tgt_keys[jt] != void_key)
    cj = np.where(same_cat)[0]
    union = (pred_areas[jp[cj]] - pred_void_area[jp[cj]]
             + tgt_areas[jt[cj]] - void_tgt_area[jt[cj]] - joint_areas[cj])
    iou = joint_areas[cj] / union
    matched = iou > 0.5

    pred_matched = np.zeros(len(pred_keys), bool)
    tgt_matched = np.zeros(len(tgt_keys), bool)
    for j, i in zip(cj[matched], iou[matched]):
        cont = cat_to_cont[int(pred_cat[jp[j]])]
        iou_sum[cont] += i
        tp[cont] += 1
        pred_matched[jp[j]] = True
        tgt_matched[jt[j]] = True

    # false negatives: unmatched target segments, unless mostly void in pred
    for t in np.where(~tgt_matched)[0]:
        if tgt_keys[t] == void_key:
            continue
        if void_tgt_area[t] / tgt_areas[t] > 0.5:
            continue
        fn[cat_to_cont[int(tgt_cat[t])]] += 1

    # false positives: unmatched pred segments, unless mostly void in target
    for p in np.where(~pred_matched)[0]:
        if pred_keys[p] == void_key:
            continue
        if pred_void_area[p] / pred_areas[p] > 0.5:
            continue
        fp[cat_to_cont[int(pred_cat[p])]] += 1

    return things, stuff, iou_sum, tp, fp, fn


def panoptic_quality_compute(things, stuff, iou_sum, tp, fp, fn):
    denom = tp + 0.5 * fp + 0.5 * fn
    with np.errstate(divide="ignore", invalid="ignore"):
        pq = np.where(denom > 0, iou_sum / denom, 0.0)
        sq = np.where(tp > 0, iou_sum / np.maximum(tp, 1), 0.0)
        rq = np.where(denom > 0, tp / denom, 0.0)
    return float(np.mean(pq) if len(pq) else 0.0), \
        float(np.mean(sq) if len(sq) else 0.0), \
        float(np.mean(rq) if len(rq) else 0.0)


def panoptic_quality(preds, target, things: Set[int], stuff: Set[int],
                     allow_unknown_preds_category: bool = False,
                     robust: float = 0.005):
    """(PQ, SQ, RQ) averaged over all present robust categories.

    Reference: util/panoptic_quality.py:225-247.
    """
    things, stuff, iou_sum, tp, fp, fn = panoptic_quality_match(
        preds, target, things, stuff, allow_unknown_preds_category, robust)
    return panoptic_quality_compute(things, stuff, iou_sum, tp, fp, fn)
