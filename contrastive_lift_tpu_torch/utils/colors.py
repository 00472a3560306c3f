"""Deterministic distinct label colors for panoptic visualization.

The port's copy of ``contrastive_lift_tpu/utils/colors.py``.

Same capability as the reference's hand-picked 70-color LUT + Glasbey files
(reference: util/distinct_colors.py:7-65, colormaps/) but generated
procedurally: golden-ratio hue stepping with varied saturation/value tiers
gives thousands of well-separated colors without shipping data files.
"""
from __future__ import annotations

import colorsys

import numpy as np

_GOLDEN = 0.61803398875


def distinct_colors(n: int, seed: int = 0) -> np.ndarray:
    """[n, 3] float RGB in [0,1]; stable for any n (supports 1000+ labels)."""
    sat_tiers = (0.85, 0.55, 0.95, 0.70)
    val_tiers = (0.95, 0.70, 0.55, 0.85)
    out = np.zeros((n, 3), np.float32)
    h = 0.12 + seed * 0.017
    for i in range(n):
        h = (h + _GOLDEN) % 1.0
        s = sat_tiers[(i // 7) % len(sat_tiers)]
        v = val_tiers[(i // 13) % len(val_tiers)]
        out[i] = colorsys.hsv_to_rgb(h, s, v)
    return out


class DistinctColors:
    """Label -> color mapper with a persistent assignment, id 0 = black-ish."""

    def __init__(self, capacity: int = 8192, seed: int = 0):
        lut = distinct_colors(capacity, seed)
        lut[0] = np.array([0.1, 0.1, 0.1], np.float32)  # background/void
        self.lut = lut

    def apply(self, labels: np.ndarray) -> np.ndarray:
        labels = np.asarray(labels).astype(np.int64) % len(self.lut)
        return self.lut[labels]


def colorize_semantics(labels: np.ndarray, num_classes: int | None = None,
                       seed: int = 1) -> np.ndarray:
    return DistinctColors(seed=seed).apply(labels)


def visualize_depth(depth: np.ndarray, min_val=None, max_val=None) -> np.ndarray:
    """Depth -> perceptual colormap [H*W, 3] (reference uses cv2 jet)."""
    d = np.asarray(depth, np.float32)
    lo = np.min(d) if min_val is None else min_val
    hi = np.max(d) if max_val is None else max_val
    t = np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    # simple turbo-like ramp: blue -> cyan -> yellow -> red
    r = np.clip(1.5 - np.abs(2.0 * t - 1.6) * 2.0, 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * t - 1.0) * 2.0, 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * t - 0.4) * 2.0, 0, 1)
    return np.stack([r, g, b], -1)


def get_boundary_mask(labels_2d: np.ndarray) -> np.ndarray:
    """True where a label differs from a 4-neighbor (instance boundaries).

    Capability match for reference util/misc.py:259-294 (which uses cv2).
    """
    lab = np.asarray(labels_2d)
    edge = np.zeros(lab.shape, bool)
    edge[:-1, :] |= lab[:-1, :] != lab[1:, :]
    edge[1:, :] |= lab[1:, :] != lab[:-1, :]
    edge[:, :-1] |= lab[:, :-1] != lab[:, 1:]
    edge[:, 1:] |= lab[:, 1:] != lab[:, :-1]
    return edge


def probability_to_normalized_entropy(probs: np.ndarray) -> np.ndarray:
    """Normalized entropy in [0,1] per pixel (reference util/misc.py:251-256)."""
    p = np.clip(np.asarray(probs), 1e-8, 1.0)
    ent = -(p * np.log(p)).sum(-1) / np.log(p.shape[-1])
    return ent
