"""Panoptic visualization grids.

The port's copy of ``contrastive_lift_tpu/utils/viz.py``, in numpy: the
entropy panel's softmax is numpy's, and ``save_image`` writes a PNG
(``utils/png.py``) where the JAX package writes through PIL. It builds the
5-or-15 panel grid of rgb / semantics / boundary-blacked colorized instances
(alpha-blended over rgb) / depth / entropy, for prediction and optionally
machine-label + GT rows.
"""
from __future__ import annotations

import numpy as np

from .colors import (DistinctColors, get_boundary_mask,
                     probability_to_normalized_entropy, visualize_depth)
from .png import write_png


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _alpha_blend(base: np.ndarray, overlay: np.ndarray, alpha: float = 0.65):
    return alpha * overlay + (1 - alpha) * base


def _panel_instances(rgb_img, instances_2d, colorizer):
    colored = colorizer.apply(instances_2d.reshape(-1)).reshape(*instances_2d.shape, 3)
    colored[get_boundary_mask(instances_2d)] = 0.0
    return _alpha_blend(rgb_img, colored)


def _panel_semantics(rgb_img, semantics_2d, colorizer):
    colored = colorizer.apply(semantics_2d.reshape(-1)).reshape(*semantics_2d.shape, 3)
    return _alpha_blend(rgb_img, colored)


def visualize_panoptic_outputs(p_rgb, p_semantics, p_instances, p_depth,
                               rgb_gt, semantics_gt, instances_gt,
                               height: int, width: int, thing_classes,
                               m2f_semantics=None, m2f_instances=None,
                               visualize_entropy: bool = True) -> np.ndarray:
    """Rows of 5 panels each -> [rows*H, 5*W, 3] float image in [0,1].

    Row 1: prediction; row 2: GT (if given); row 3: machine labels (if given).
    """
    col_sem = DistinctColors(seed=1)
    col_inst = DistinctColors(seed=2)
    h, w = height, width

    def to_img(flat, ch=3):
        return np.asarray(flat).reshape(h, w, ch) if ch > 1 else \
            np.asarray(flat).reshape(h, w)

    rgb = np.clip(to_img(p_rgb), 0, 1)
    sem_lab = to_img(np.asarray(p_semantics).argmax(-1), 1)
    inst_lab = to_img(np.asarray(p_instances).argmax(-1), 1)
    depth_img = visualize_depth(np.asarray(p_depth)).reshape(h, w, 3)
    if visualize_entropy:
        # semantics may be logits: softmax for the entropy
        probs = _softmax(np.asarray(p_semantics, np.float32))
        ent = probability_to_normalized_entropy(probs).reshape(h, w)
        ent_img = np.repeat(ent[..., None], 3, -1)
    else:
        ent_img = np.zeros_like(rgb)

    def row(rgb_i, sem_i, inst_i, depth_i, ent_i):
        return np.concatenate([
            rgb_i, _panel_semantics(rgb_i, sem_i, col_sem),
            _panel_instances(rgb_i, inst_i, col_inst), depth_i, ent_i], axis=1)

    rows = [row(rgb, sem_lab, inst_lab, depth_img, ent_img)]
    if rgb_gt is not None:
        rgb_g = np.clip(to_img(rgb_gt), 0, 1)
        sem_g = to_img(np.asarray(semantics_gt), 1)
        inst_g = to_img(np.asarray(instances_gt), 1)
        rows.append(row(rgb_g, sem_g, inst_g, np.zeros_like(rgb), np.zeros_like(rgb)))
    if m2f_semantics is not None:
        sem_m = to_img(np.asarray(m2f_semantics), 1)
        inst_m = to_img(np.asarray(m2f_instances), 1)
        base = np.clip(to_img(rgb_gt), 0, 1) if rgb_gt is not None else rgb
        rows.append(row(base, sem_m, inst_m, np.zeros_like(rgb), np.zeros_like(rgb)))
    return np.concatenate(rows, axis=0)


def save_image(path, img01: np.ndarray) -> None:
    """An [H, W, 3] image in [0, 1] as an 8-bit RGB PNG at ``path``."""
    write_png(path, (np.clip(img01, 0, 1) * 255).astype(np.uint8))
