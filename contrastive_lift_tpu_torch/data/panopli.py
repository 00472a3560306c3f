"""PanopLi-layout scene reader (ScanNet / Replica / HyperSim / in-the-wild):
the port's copy of ``contrastive_lift_tpu/data/panopli.py``, decoding its
JPEG and PNG files with ``utils/jpeg.py`` and ``utils/png.py`` and resizing
with ``utils/image.py`` where the JAX package uses PIL and ``jax.image``.

On-disk contract (reference: dataset/panopli.py:42-225):
  color/*.jpg                      RGB frames (names define ordering)
  splits.json                      {"train": [...], "test": [...], "val": [...]}
  intrinsic/intrinsic_color.txt    4x4 (3x3 used), scaled to target image_dim
  pose/<name>.txt                  4x4 cam2world
  m2f_semantics/ m2f_instance/     machine panoptic labels (png, NEAREST resize)
  m2f_probabilities/<name>.npz     'probability' [h,w,C] + 'confidence' [h,w]
                                   (bilinear-resized, align_corners=False)
  m2f_segments/                    2D segment ids for the grouping loss
  features(-_bilinear)/<name>.pt   optional 64-d distilled targets (L2-normed)
  invalid/<name>.jpg               optional mask (nonzero = invalid pixel)
  rs_semantics/ rs_instance/       GT labels for evaluation
  segmentation_data.pkl            fg_classes / bg_classes /
                                   m2f_instance_to_semantic

Scene normalization: frustum-union unit sphere (max_depth), rays carry
[o, d, near=0.01, far=sphere-exit].
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import geometry as geo
from ..utils.image import (resize_bilinear_chw, resize_lanczos_uint8,
                           resize_nearest)
from ..utils.jpeg import jpeg_mode, jpeg_size, read_jpeg
from ..utils.png import read_png
from .base import FrameData, SceneData, SegmentationData
from .common import numeric_stem_key


def _read_matrix_txt(path: Path) -> np.ndarray:
    rows = [[float(y) for y in line.split()] for line in
            Path(path).read_text().splitlines() if line.strip()]
    return np.asarray(rows, np.float32)


def _load_rgb(path: Path, hw: Tuple[int, int]) -> np.ndarray:
    """A JPEG frame, PIL-LANCZOS-resized to ``hw`` in its own mode (a CMYK
    frame as CMYK), as float32 in [0, 1]; its first 3 channels."""
    img = resize_lanczos_uint8(read_jpeg(path), hw, jpeg_mode(path))
    arr = np.asarray(img, np.float32) / 255.0
    return arr[..., :3]


class PanopLiSceneReader:
    """Loads a PanopLi-layout scene into SceneData (host-side, numpy)."""

    def __init__(self, root_dir, image_dim: Tuple[int, int], max_depth: float,
                 semantics_dir: str = "m2f_semantics",
                 instance_dir: str = "m2f_instance",
                 instance_to_semantic_key: str = "m2f_instance_to_semantic",
                 load_feat: bool = False, feature_type: str = "nearest",
                 subsample_frames: int = 1, overfit: bool = False):
        self.root = Path(root_dir)
        self.image_dim = tuple(image_dim)
        self.max_depth = max_depth
        self.semantics_dir = semantics_dir
        self.instance_dir = instance_dir
        self.instance_to_semantic_key = instance_to_semantic_key
        self.load_feat = load_feat
        self.feature_type = feature_type
        self.subsample_frames = subsample_frames
        self.overfit = overfit
        self._setup()

    def _setup(self):
        self.frame_names = sorted(
            [x.stem for x in (self.root / "color").iterdir() if x.suffix == ".jpg"],
            key=numeric_stem_key)
        n = len(self.frame_names)
        if self.overfit:
            self.train_indices = self.val_indices = list(range(min(16, n)))
        elif (self.root / "splits.json").exists():
            splits = json.loads((self.root / "splits.json").read_text())
            index = {name: i for i, name in enumerate(self.frame_names)}
            self.train_indices = [index[str(x)] for x in splits["train"]]
            test_key = "test" if "test" in splits else "val"
            self.val_indices = [index[str(x)] for x in splits[test_key]]
        else:
            rng = np.random.default_rng(0)
            self.val_indices = sorted(rng.choice(n, min(n, 8), replace=False).tolist())
            self.train_indices = [i for i in range(n) if i not in self.val_indices]
        self.train_indices = self.train_indices[::self.subsample_frames]
        self.val_indices = self.val_indices[::self.subsample_frames]

        h, w = self.image_dim
        img_w, img_h = jpeg_size(self.root / "color"
                                 / f"{self.frame_names[0]}.jpg")
        intr = _read_matrix_txt(self.root / "intrinsic" / "intrinsic_color.txt")[:3, :3]
        scale = np.diag([w / img_w, h / img_h, 1.0]).astype(np.float32)
        self.intrinsics = (scale @ intr).astype(np.float32)

        poses = {}
        dims, intrinsics_l, cam2scene = [], [], []
        for name in self.frame_names:
            c2w = _read_matrix_txt(self.root / "pose" / f"{name}.txt")
            poses[name] = c2w
            cam2scene.append(c2w)
            dims.append([img_h, img_w])
            intrinsics_l.append(intr)
        self.scene2normscene = geo.compute_world2normscene(
            np.asarray(dims, np.float32), np.asarray(intrinsics_l, np.float32),
            np.asarray(cam2scene, np.float32), max_depth=self.max_depth)
        self.normscene_scale = float(self.scene2normscene[0, 0])
        self.cam2normscene = {name: self.scene2normscene @ poses[name]
                              for name in self.frame_names}

        seg_pkl = pickle.load(open(self.root / "segmentation_data.pkl", "rb"))
        fg = sorted(seg_pkl["fg_classes"])
        bg = sorted(seg_pkl["bg_classes"])
        self.segmentation = SegmentationData(
            fg_classes=fg, bg_classes=bg,
            num_semantic_classes=len(fg) + len(bg),
            instance_to_semantics=seg_pkl.get(self.instance_to_semantic_key, {}),
            num_instances=len(fg))

    # -- frame loading --------------------------------------------------------

    def _rays_for(self, name: str) -> np.ndarray:
        from .native import build_rays
        h, w = self.image_dim
        return build_rays(h, w, self.intrinsics, self.cam2normscene[name])

    def load_frame(self, index: int, with_gt: bool = False,
                   with_segments: bool = False) -> FrameData:
        name = self.frame_names[index]
        h, w = self.image_dim
        rgb = _load_rgb(self.root / "color" / f"{name}.jpg", (h, w)).reshape(-1, 3)
        sem = resize_nearest(read_png(
            self.root / self.semantics_dir / f"{name}.png"), (h, w))
        inst = resize_nearest(read_png(
            self.root / self.instance_dir / f"{name}.png"), (h, w))

        prefix = self.semantics_dir.split("_")[0]
        if prefix != "rs":
            npz = np.load(self.root / f"{prefix}_probabilities" / f"{name}.npz")
            probs = np.asarray(npz["probability"], np.float32)     # [h0,w0,C]
            confs = np.asarray(npz["confidence"], np.float32)      # [h0,w0]
            if "notta" in self.semantics_dir:
                confs = (np.asarray(npz["confidence_notta"], np.float32)
                         if "confidence_notta" in npz else np.ones_like(confs))
            stack = np.concatenate([probs.transpose(2, 0, 1), confs[None]], 0)
            stack = resize_bilinear_chw(stack, (h, w))
            probs = stack[:-1].transpose(1, 2, 0)
            confs = stack[-1]
        else:
            num_c = self.segmentation.num_semantic_classes
            probs = np.eye(num_c, dtype=np.float32)[sem]
            confs = np.ones((h, w), np.float32)

        feats = None
        if self.load_feat:
            fdir = "features" if self.feature_type == "nearest" else "features_bilinear"
            npy = self.root / fdir / f"{name}.npy"
            if npy.exists():
                f = np.load(npy).astype(np.float32)
            else:
                f = torch.load(self.root / fdir / f"{name}.pt",
                               map_location="cpu",
                               weights_only=True).numpy().astype(np.float32)
            f = resize_bilinear_chw(f.transpose(2, 0, 1), (h, w)).transpose(1, 2, 0)
            f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12)
            feats = f.reshape(-1, f.shape[-1])

        mask_path = self.root / "invalid" / f"{name}.jpg"
        if mask_path.exists():
            invalid = resize_nearest(read_jpeg(mask_path), (h, w)) > 0
            mask = ~invalid.reshape(-1)
        else:
            mask = np.ones(h * w, bool)

        gt_sem = gt_inst = None
        # per-FILE check: GT-less captures (itw) have the folders but no pngs
        # (both maps must exist — a semantics-only export stays GT-less)
        if (with_gt
                and (self.root / "rs_semantics" / f"{name}.png").exists()
                and (self.root / "rs_instance" / f"{name}.png").exists()):
            gt_sem = resize_nearest(read_png(
                self.root / "rs_semantics" / f"{name}.png"), (h, w)).reshape(-1)
            gt_inst = resize_nearest(read_png(
                self.root / "rs_instance" / f"{name}.png"), (h, w)).reshape(-1)

        segments = None
        seg_path = self.root / "m2f_segments" / f"{name}.png"
        if with_segments and seg_path.exists():
            segments = resize_nearest(read_png(seg_path),
                                       (h, w)).reshape(-1).astype(np.int64)

        return FrameData(
            name=name, rays=self._rays_for(name), rgbs=rgb,
            semantics=sem.reshape(-1).astype(np.int64),
            instances=inst.reshape(-1).astype(np.int64),
            probabilities=probs.reshape(-1, probs.shape[-1]),
            confidences=confs.reshape(-1), mask=mask, feats=feats,
            gt_semantics=(gt_sem.astype(np.int64) if gt_sem is not None else None),
            gt_instances=(gt_inst.astype(np.int64) if gt_inst is not None else None),
            intrinsics=self.intrinsics,
            cam2normscene=self.cam2normscene[name].astype(np.float32),
            segments=segments)

    def load_scene(self, load_train: bool = True, load_val: bool = True,
                   with_segments: bool = True) -> SceneData:
        train = ([self.load_frame(i, with_segments=with_segments)
                  for i in self.train_indices] if load_train else [])
        val = ([self.load_frame(i, with_gt=True) for i in self.val_indices]
               if load_val else [])
        fg, bg = set(self.segmentation.fg_classes), set(self.segmentation.bg_classes)
        return SceneData(
            train_frames=train, val_frames=val, segmentation=self.segmentation,
            image_dim=self.image_dim,
            things_filtered=fg - {0}, stuff_filtered=bg - {0},
            faulty_classes={0})
