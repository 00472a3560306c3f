"""PSNR / confusion-matrix mIoU, in numpy.

The port's copy of ``contrastive_lift_tpu/metrics/metrics.py`` (which
computes ``mse`` with ``jax.numpy``).
"""
from __future__ import annotations

import numpy as np


def mse(image_pred, image_gt, valid_mask=None):
    value = (np.asarray(image_pred) - np.asarray(image_gt)) ** 2
    if valid_mask is not None:
        value = np.where(np.asarray(valid_mask)[..., None]
                         if value.ndim > valid_mask.ndim
                         else np.asarray(valid_mask), value, np.nan)
        return np.nanmean(value)
    return np.mean(value)


def psnr(image_pred, image_gt, valid_mask=None):
    return -10.0 * np.log10(mse(image_pred, image_gt, valid_mask))


def get_non_robust_classes(confusion_matrix: np.ndarray, robustness_thres: float):
    """Classes with <thres fraction of pixels on both axes (reference: util/metrics.py:29-35)."""
    axis_0 = confusion_matrix.sum(axis=0)
    axis_1 = confusion_matrix.sum(axis=1)
    total = axis_0.sum()
    non_robust_0 = axis_0 / total < robustness_thres
    non_robust_1 = axis_1 / total < robustness_thres
    return np.where(np.logical_and(non_robust_0, non_robust_1))[0].tolist()


def calculate_miou(confusion_matrix: np.ndarray, ignore_class=None, robust=0.005):
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.diag(confusion_matrix) / (
            confusion_matrix.sum(axis=1) + confusion_matrix.sum(axis=0)
            - np.diag(confusion_matrix))
    if ignore_class is not None:
        ignore = list(ignore_class) + get_non_robust_classes(confusion_matrix, robust)
        for i in ignore:
            iou[i] = float("nan")
    return float(np.nanmean(iou))


class ConfusionMatrix:
    """Streaming confusion matrix with robust-class filtering (host-side numpy)."""

    def __init__(self, num_classes: int, ignore_class=None, robust: float = 0.005):
        self.num_classes = num_classes
        self.ignore_class = list(ignore_class) if ignore_class is not None else None
        self.robust = robust
        self.confusion_matrix = np.zeros((num_classes, num_classes))

    def _generate(self, gt, pred):
        gt = np.asarray(gt).reshape(-1)
        pred = np.asarray(pred).reshape(-1)
        mask = (gt >= 0) & (gt < self.num_classes)
        label = self.num_classes * gt[mask].astype(int) + pred[mask].astype(int)
        count = np.bincount(label, minlength=self.num_classes**2)
        return count.reshape(self.num_classes, self.num_classes)

    def _ignore(self):
        # ignore_class=[] still triggers the robust-class filter (reference
        # util/metrics.py:40-42 checks `is not None`, not truthiness).
        return list(self.ignore_class) if self.ignore_class is not None else None

    def add_batch(self, gt, pred, return_miou: bool = False):
        cm = self._generate(gt, pred)
        self.confusion_matrix += cm
        if return_miou:
            return calculate_miou(cm, self._ignore(), self.robust)

    def get_miou(self):
        return calculate_miou(self.confusion_matrix, self._ignore(), self.robust)

    def reset(self):
        self.confusion_matrix = np.zeros((self.num_classes, self.num_classes))
