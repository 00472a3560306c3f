"""Shared preprocessing utilities: the common on-disk layout, keyframe
selection, label folding, instance renumbering. The port's copy of
``contrastive_lift_tpu/data/preprocessing/common.py``.

Every per-dataset script funnels raw captures into one layout that the
readers consume:

    color/ pose/ intrinsic/intrinsic_color.txt
    m2f_semantics/ m2f_instance/ m2f_probabilities/ m2f_segments/
    rs_semantics/ rs_instance/ splits.json segmentation_data.pkl

The files are the ones PIL writes for the JAX package: colour JPEGs at
quality 95 and grey invalid masks at PIL's default quality 75, byte for
byte (``utils/jpeg.py::write_jpeg``), and PNGs with the same header and
pixels (``utils/png.py::write_png``).
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...utils.jpeg import write_jpeg
from ...utils.png import write_png
from ..common import numeric_stem_key

__all__ = ["numeric_stem_key", "save_id_image", "blur_score",
           "select_keyframes", "fold_semantics", "renumber_instances",
           "SceneWriter"]


def save_id_image(ids: np.ndarray, path) -> None:
    """Write an integer label/id map as PNG: 8-bit grey up to 255, 16-bit
    grey above (a uint8 cast would wrap id 256 to 0, void, and fuse
    distinct objects); ``ValueError`` outside [0, 65535]."""
    ids = np.asarray(ids)
    hi = int(ids.max(initial=0))
    lo = int(ids.min(initial=0))
    if lo < 0 or hi > int(np.iinfo(np.uint16).max):
        raise ValueError(f"id image outside PNG range: [{lo}, {hi}]")
    dtype = np.uint8 if hi <= int(np.iinfo(np.uint8).max) else np.uint16
    write_png(path, ids.astype(dtype))


def blur_score(image: np.ndarray) -> float:
    """Variance of a 3x3 Laplacian response (higher = sharper)."""
    gray = np.asarray(image, np.float32)
    if gray.ndim == 3:
        gray = gray.mean(-1)
    lap = (-4 * gray[1:-1, 1:-1] + gray[:-2, 1:-1] + gray[2:, 1:-1]
           + gray[1:-1, :-2] + gray[1:-1, 2:])
    return float(lap.var())


def select_keyframes(blur_scores: Sequence[float], window: int = 8) -> List[int]:
    """Pick the sharpest frame from every consecutive window."""
    scores = np.asarray(blur_scores, np.float64)
    picks = []
    for start in range(0, len(scores), window):
        chunk = scores[start:start + window]
        picks.append(start + int(np.argmax(chunk)))
    return picks


def fold_semantics(labels: np.ndarray, mapping: Dict[int, int],
                   default: int = 0) -> np.ndarray:
    """Apply a raw->reduced class mapping via a LUT (unknown -> default)."""
    labels = np.asarray(labels, np.int64)
    max_id = max(int(labels.max(initial=0)), max(mapping, default=0))
    lut = np.full(max_id + 1, default, np.int64)
    for src, dst in mapping.items():
        lut[src] = dst
    return lut[labels]


def renumber_instances(all_instances: List[np.ndarray],
                       all_semantics: List[np.ndarray],
                       thing_classes: set) -> tuple:
    """Make instance ids dense and consistent: ids on stuff pixels -> 0,
    thing instances renumbered 1..K scene-wide (by raw id and majority
    class); returns (new_instances, instance_to_semantics)."""
    pair_to_new: Dict[tuple, int] = {}
    inst_to_sem: Dict[int, int] = {0: 0}
    out = []
    for inst, sem in zip(all_instances, all_semantics):
        inst = np.asarray(inst, np.int64)
        sem = np.asarray(sem, np.int64)
        new = np.zeros_like(inst)
        for raw_id in np.unique(inst):
            if raw_id == 0:
                continue
            mask = inst == raw_id
            cls_ids, counts = np.unique(sem[mask], return_counts=True)
            cls = int(cls_ids[np.argmax(counts)])
            if cls not in thing_classes:
                continue
            key = (int(raw_id), cls)
            if key not in pair_to_new:
                pair_to_new[key] = len(pair_to_new) + 1
                inst_to_sem[pair_to_new[key]] = cls
            new[mask] = pair_to_new[key]
        out.append(new)
    return out, inst_to_sem


class SceneWriter:
    """Writes the common scene layout that ``data/panopli.py`` reads."""

    def __init__(self, out_dir):
        self.root = Path(out_dir)
        for sub in ("color", "pose", "intrinsic", "m2f_semantics",
                    "m2f_instance", "m2f_probabilities", "m2f_segments",
                    "rs_semantics", "rs_instance", "depth", "invalid"):
            (self.root / sub).mkdir(parents=True, exist_ok=True)
        self.names: List[str] = []

    def add_frame(self, name: str, rgb: np.ndarray, cam2world: np.ndarray,
                  m2f_semantics: np.ndarray, m2f_instance: np.ndarray,
                  probabilities: np.ndarray, confidence: np.ndarray,
                  gt_semantics: Optional[np.ndarray] = None,
                  gt_instance: Optional[np.ndarray] = None,
                  segments: Optional[np.ndarray] = None,
                  depth: Optional[np.ndarray] = None,
                  invalid: Optional[np.ndarray] = None) -> None:
        self.names.append(name)
        write_jpeg(self.root / "color" / f"{name}.jpg",
                   np.asarray(rgb, np.uint8), quality=95)
        np.savetxt(self.root / "pose" / f"{name}.txt", np.asarray(cam2world))
        save_id_image(m2f_semantics,
                      self.root / "m2f_semantics" / f"{name}.png")
        save_id_image(m2f_instance,
                      self.root / "m2f_instance" / f"{name}.png")
        np.savez_compressed(self.root / "m2f_probabilities" / f"{name}.npz",
                            probability=np.asarray(probabilities, np.float32),
                            confidence=np.asarray(confidence, np.float32))
        if segments is not None:
            save_id_image(segments,
                          self.root / "m2f_segments" / f"{name}.png")
        if gt_semantics is not None:
            save_id_image(gt_semantics,
                          self.root / "rs_semantics" / f"{name}.png")
        if gt_instance is not None:
            save_id_image(gt_instance,
                          self.root / "rs_instance" / f"{name}.png")
        if depth is not None:
            depth_mm = (np.asarray(depth, np.float32) * 1000).astype(np.uint16)
            write_png(self.root / "depth" / f"{name}.png", depth_mm)
        if invalid is not None:
            write_jpeg(self.root / "invalid" / f"{name}.jpg",
                       (np.asarray(invalid) > 0).astype(np.uint8) * 255)

    def write_intrinsics(self, intrinsics_4x4: np.ndarray) -> None:
        np.savetxt(self.root / "intrinsic" / "intrinsic_color.txt",
                   np.asarray(intrinsics_4x4))

    def write_splits(self, train_names: Sequence[str],
                     test_names: Sequence[str]) -> None:
        (self.root / "splits.json").write_text(json.dumps(
            {"train": list(train_names), "test": list(test_names)}))

    def write_segmentation_data(self, fg_classes, bg_classes,
                                instance_to_semantics) -> None:
        with open(self.root / "segmentation_data.pkl", "wb") as f:
            pickle.dump({
                "fg_classes": sorted(fg_classes),
                "bg_classes": sorted(bg_classes),
                "m2f_instance_to_semantic": dict(instance_to_semantics),
            }, f)
