"""Messy Rooms ("Many Object Scenes") reader — Detic pseudo-labels, unbounded
instance counts (up to 500 objects per scene). The port's copy of
``contrastive_lift_tpu/data/mos.py``, reading its PNG colour with
``utils/png.py`` where the JAX package uses PIL.

On-disk contract (reference: dataset/many_object_scenes.py:22-232):
  color/*.png
  metadata.json          camera.K normalized (rows scaled by W, H, abs'ed),
                         camera.positions + camera.quaternions (wxyz) in
                         blender convention -> right-multiplied by
                         diag(1,-1,-1,1) for opencv
  detic_semantic/*.npy   machine semantics (0 = bg, 1 = fg)
  detic_instance/*.npy   machine instance ids (frame-inconsistent)
  detic_probabilities/*.npy  per-pixel confidence; bg pixels forced to 1.0
  semantic/ instance/    GT labels (npy) for evaluation
Split: deterministic last 20% of frames = test (reference :69-76).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils import geometry as geo
from ..utils.image import (resize_bilinear_chw, resize_lanczos_uint8,
                           resize_nearest)
from ..utils.png import read_png
from .base import FrameData, SceneData, SegmentationData
from .common import numeric_stem_key


def quaternion_to_rotation(q) -> np.ndarray:
    """wxyz quaternion -> 3x3 rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def read_mos_cameras(meta: dict, img_h: int, img_w: int):
    """(K, [cam2world]) from metadata.json (reference :22-40)."""
    K = np.asarray(meta["camera"]["K"], np.float64).copy()
    K[0] *= img_w
    K[1] *= img_h
    K = np.abs(K)
    blender2opencv = np.diag([1.0, -1.0, -1.0, 1.0])
    poses = []
    for t, q in zip(meta["camera"]["positions"], meta["camera"]["quaternions"]):
        pose = np.eye(4)
        pose[:3, :3] = quaternion_to_rotation(q)
        pose[:3, 3] = np.asarray(t, np.float64)
        poses.append((pose @ blender2opencv).astype(np.float32))
    return K.astype(np.float32), poses


class MOSSceneReader:
    """Loads a MOS-layout scene into SceneData."""

    def __init__(self, root_dir, image_dim: Tuple[int, int], max_depth: float,
                 semantics_dir: str = "detic_semantic",
                 instance_dir: str = "detic_instance",
                 subsample_frames: int = 1, overfit: bool = False,
                 train_val_ratio: float = 0.8):
        self.root = Path(root_dir)
        self.image_dim = tuple(image_dim)
        self.max_depth = max_depth
        self.semantics_dir = semantics_dir
        self.instance_dir = instance_dir
        self.subsample_frames = subsample_frames
        self.overfit = overfit
        self.train_val_ratio = train_val_ratio
        self._setup()

    def _setup(self):
        self.frame_names = sorted(
            [x.stem for x in (self.root / "color").iterdir() if x.suffix == ".png"],
            key=numeric_stem_key)
        n = len(self.frame_names)
        # deterministic fixed split: last 20% are test frames
        split_at = int(n * self.train_val_ratio)
        self.val_indices = list(range(split_at, n))
        self.train_indices = list(range(split_at))
        if self.overfit:
            self.train_indices = self.val_indices = list(range(min(4, n)))
        self.train_indices = self.train_indices[::self.subsample_frames]
        self.val_indices = self.val_indices[::self.subsample_frames]

        img_h, img_w = read_png(self.root / "color"
                                / f"{self.frame_names[0]}.png").shape[:2]
        meta = json.loads((self.root / "metadata.json").read_text())
        K, poses = read_mos_cameras(meta, img_h, img_w)
        h, w = self.image_dim
        self.intrinsics = (np.diag([w / img_w, h / img_h, 1.0]) @ K).astype(np.float32)

        dims = np.full((n, 2), [img_h, img_w], np.float32)
        intr_l = np.tile(K, (n, 1, 1))
        self.scene2normscene = geo.compute_world2normscene(
            dims, intr_l, np.stack(poses), max_depth=self.max_depth)
        self.cam2normscene = {name: self.scene2normscene @ poses[i]
                              for i, name in enumerate(self.frame_names)}
        # two semantic classes: background (stuff) and foreground (things)
        self.segmentation = SegmentationData(
            fg_classes=[1], bg_classes=[0], num_semantic_classes=2,
            num_instances=1)

    def _rays_for(self, name: str) -> np.ndarray:
        from .native import build_rays
        h, w = self.image_dim
        return build_rays(h, w, self.intrinsics, self.cam2normscene[name])

    def load_frame(self, index: int, with_gt: bool = False) -> FrameData:
        name = self.frame_names[index]
        h, w = self.image_dim
        img = resize_lanczos_uint8(read_png(self.root / "color"
                                            / f"{name}.png"), (h, w))
        rgb = (np.asarray(img, np.float32) / 255.0)[..., :3].reshape(-1, 3)

        sem_raw = np.load(self.root / self.semantics_dir / f"{name}.npy")
        inst_raw = np.load(self.root / self.instance_dir / f"{name}.npy")
        if self.semantics_dir.split("_")[0] != "semantic":
            prefix = self.semantics_dir.split("_")[0]
            confs = np.load(self.root / f"{prefix}_probabilities" / f"{name}.npy"
                            ).astype(np.float32)
            confs[sem_raw == 0] = 1.0   # background confidence forced to 1
        else:
            confs = np.ones_like(sem_raw, np.float32)

        sem = resize_nearest(sem_raw.astype(np.uint8), (h, w)).astype(np.int64)
        inst = resize_nearest(inst_raw.astype(np.int16), (h, w)).astype(np.int64)
        confs = resize_bilinear_chw(confs[None], (h, w))[0]
        probs = np.eye(2, dtype=np.float32)[sem]

        gt_sem = gt_inst = None
        if with_gt and (self.root / "semantic").exists():
            gt_sem = resize_nearest(
                np.load(self.root / "semantic" / f"{name}.npy").astype(np.uint8),
                (h, w)).reshape(-1).astype(np.int64)
            gt_inst = resize_nearest(
                np.load(self.root / "instance" / f"{name}.npy").astype(np.int16),
                (h, w)).reshape(-1).astype(np.int64)

        return FrameData(
            name=name, rays=self._rays_for(name), rgbs=rgb,
            semantics=sem.reshape(-1), instances=inst.reshape(-1),
            probabilities=probs.reshape(-1, 2), confidences=confs.reshape(-1),
            mask=np.ones(h * w, bool),
            gt_semantics=gt_sem, gt_instances=gt_inst,
            intrinsics=self.intrinsics,
            cam2normscene=self.cam2normscene[name].astype(np.float32))

    def load_scene(self, load_train: bool = True, load_val: bool = True) -> SceneData:
        train = ([self.load_frame(i) for i in self.train_indices]
                 if load_train else [])
        val = ([self.load_frame(i, with_gt=True) for i in self.val_indices]
               if load_val else [])
        return SceneData(
            train_frames=train, val_frames=val, segmentation=self.segmentation,
            image_dim=self.image_dim,
            things_filtered={1}, stuff_filtered=set(), faulty_classes={0})
