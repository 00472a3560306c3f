"""Offline evaluation: folder-vs-folder mIoU + PQ^scene. The port's copy of
``contrastive_lift_tpu/inference/evaluate.py``, reading PNG labels with
``utils/png.py`` and resizing them with ``utils/image.py`` where the JAX
package uses PIL.

The reference's headline metric is PQ^scene: predictions and GT of ALL test
frames are concatenated into one tensor before a single PQ computation, so
instance ids must be consistent across views (reference:
dataset/preprocessing/preprocess_scannet.py:685-732, inference/evaluate.py:14-37).

Masking semantics (reference-exact):
* PanopLi layout: GT class 0 marks faulty annotation regions. The reference
  DROPS those pixels via `valid_mask = ~np.isin(img_target, faulty_gt)` before
  feeding the confusion matrix / PQ tensors (preprocess_scannet.py:628-634,
  693-704) and uses `ignore_class=[]` for mIoU — class 0 can therefore still
  appear (as a 0-IoU row) if predictions emit it on valid pixels.
* MOS layout: class 0 is the REAL background class; the reference MOS
  evaluators use an all-valid mask and 2 classes
  (calculate_iou_folders_MOS :636-655, calculate_panoptic_quality_folders_MOS
  :708-732). No masking whatsoever.
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence, Set, Tuple

import numpy as np

from ..metrics.metrics import ConfusionMatrix
from ..metrics.panoptic_quality import panoptic_quality
from ..utils.image import resize_nearest
from ..utils.png import read_png


def _load_label_png(path, image_size: Tuple[int, int]) -> np.ndarray:
    """Label map from png (predictions / PanopLi GT) or npy (MOS GT —
    reference preprocess_scannet.py:599-602 reads detic/GT npy files),
    NEAREST-resized to ``image_size`` only where its size differs."""
    path = Path(path)
    if not path.exists() and path.with_suffix(".npy").exists():
        path = path.with_suffix(".npy")
    if path.suffix == ".npy":
        arr = np.load(path).astype(np.int32)   # PIL mode "I"
    else:
        arr = read_png(path)
    if arr.shape[:2] != tuple(image_size):
        arr = resize_nearest(arr, image_size)
    return np.asarray(arr).astype(np.int64)


def calculate_iou_folders(path_pred: Path, path_target: Path,
                          image_size=(512, 512), num_classes: int = 256,
                          faulty_classes: Sequence[int] = (0,)) -> float:
    """PanopLi mIoU over matching names: pixels whose GT class is faulty are
    DROPPED (not overwritten), and mIoU runs with ignore_class=[] so only the
    robustness filter prunes classes (reference: preprocess_scannet.py:622-634).
    """
    cm = ConfusionMatrix(num_classes, ignore_class=[])
    for pred_file in sorted(Path(path_pred).iterdir()):
        tgt_file = Path(path_target) / pred_file.name
        pred = _load_label_png(pred_file, image_size)
        target = _load_label_png(tgt_file, image_size)
        valid = ~np.isin(target, list(faulty_classes))
        cm.add_batch(target[valid], pred[valid])
    return cm.get_miou()


def calculate_iou_folders_mos(path_pred: Path, path_target: Path,
                              image_size=(512, 512)) -> float:
    """MOS mIoU: 2 classes (bg/fg), no faulty-GT masking, ignore_class=[]
    (reference: preprocess_scannet.py:636-655)."""
    cm = ConfusionMatrix(2, ignore_class=[])
    for pred_file in sorted(Path(path_pred).iterdir()):
        tgt_file = Path(path_target) / pred_file.name
        pred = _load_label_png(pred_file, image_size)
        target = _load_label_png(tgt_file, image_size)
        cm.add_batch(target, pred)
    return cm.get_miou()


def _load_pq_frame(path_pred_sem, path_pred_inst, path_target_sem,
                   path_target_inst, name, image_size,
                   faulty_classes: Sequence[int]):
    """One frame's (pred, target) [N,2] tensors with faulty-GT pixels dropped."""
    sem_p = _load_label_png(Path(path_pred_sem) / name, image_size)
    inst_p = _load_label_png(Path(path_pred_inst) / name, image_size)
    sem_t = _load_label_png(Path(path_target_sem) / name, image_size)
    inst_t = _load_label_png(Path(path_target_inst) / name, image_size)
    if faulty_classes:
        valid = ~np.isin(sem_t, list(faulty_classes))
    else:  # MOS: all pixels valid (reference :723)
        valid = np.ones_like(sem_t, dtype=bool)
    pred = np.stack([sem_p[valid], inst_p[valid]], -1).reshape(-1, 2)
    target = np.stack([sem_t[valid], inst_t[valid]], -1).reshape(-1, 2)
    return pred, target


def calculate_panoptic_quality_folders(
        path_pred_sem: Path, path_pred_inst: Path,
        path_target_sem: Path, path_target_inst: Path,
        things: Set[int], stuff: Set[int], image_size=(512, 512),
        faulty_classes: Sequence[int] = (0,)):
    """PQ^scene: all frames concatenated before one PQ pass, faulty-GT pixels
    dropped per frame (reference: preprocess_scannet.py:685-705; pass
    faulty_classes=() for the MOS variant :708-732).
    """
    preds, targets = [], []
    for pred_file in sorted(Path(path_pred_sem).iterdir()):
        pred, target = _load_pq_frame(
            path_pred_sem, path_pred_inst, path_target_sem, path_target_inst,
            pred_file.name, image_size, faulty_classes)
        preds.append(pred)
        targets.append(target)
    return panoptic_quality(np.concatenate(preds), np.concatenate(targets),
                            things, stuff, allow_unknown_preds_category=True)


def calculate_panoptic_quality_per_frame_folders(
        path_pred_sem: Path, path_pred_inst: Path,
        path_target_sem: Path, path_target_inst: Path,
        things: Set[int], stuff: Set[int], image_size=(512, 512),
        faulty_classes: Sequence[int] = (0,)):
    """Per-frame PQ averaged, faulty-GT pixels dropped (reference:
    calculate_panoptic_quality_folders_image_wise, preprocess_scannet.py:661-683)."""
    rows = []
    for pred_file in sorted(Path(path_pred_sem).iterdir()):
        pred, target = _load_pq_frame(
            path_pred_sem, path_pred_inst, path_target_sem, path_target_inst,
            pred_file.name, image_size, faulty_classes)
        rows.append(panoptic_quality(pred, target, things, stuff,
                                     allow_unknown_preds_category=True))
    arr = np.asarray(rows)
    return tuple(arr.mean(axis=0))


def evaluate_folders(root_pred: Path, root_target: Path, things: Set[int],
                     stuff: Set[int], image_size=(512, 512),
                     faulty_classes=(0,)) -> dict:
    """The evaluate.py CLI core: mIoU + PQ/SQ/RQ^scene (reference:
    inference/evaluate.py:14-37). Autodetects the GT layout: PanopLi
    (rs_semantics/rs_instance pngs; faulty-class pixels dropped) or MOS
    (semantic/instance npys; all pixels valid, 2 classes — reference
    preprocess_scannet.py:636-655,708-732)."""
    root_target = Path(root_target)
    if (root_target / "rs_semantics").exists():
        gt_sem, gt_inst = root_target / "rs_semantics", root_target / "rs_instance"
        miou = calculate_iou_folders(
            Path(root_pred) / "pred_semantics", gt_sem, image_size,
            faulty_classes=faulty_classes)
        pq_faulty = tuple(faulty_classes)
    else:  # MOS layout: class 0 is real background — evaluate every pixel
        gt_sem, gt_inst = root_target / "semantic", root_target / "instance"
        miou = calculate_iou_folders_mos(
            Path(root_pred) / "pred_semantics", gt_sem, image_size)
        pq_faulty = ()
    pq, sq, rq = calculate_panoptic_quality_folders(
        Path(root_pred) / "pred_semantics", Path(root_pred) / "pred_surrogateid",
        gt_sem, gt_inst, things, stuff, image_size, faulty_classes=pq_faulty)
    return {"iou": miou, "pq": pq, "sq": sq, "rq": rq}
