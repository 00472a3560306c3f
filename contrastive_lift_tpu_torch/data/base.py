"""Scene data containers and the three batch streams (host-side numpy).

The port's copy of ``contrastive_lift_tpu/data/base.py``: the containers
``SegmentationData``, ``FrameData`` and ``SceneData``, and the samplers of
the training step, which draw from a ``np.random.Generator`` exactly as the
JAX package's do, so one seed gives both packages the same batches:
  0. ``RayPoolSampler``: flat i.i.d. ray batches;
  1. ``InstanceBundleSampler``: per-image bundles of labeled-instance rays,
     labels compacted to [0, max_labels);
  2. ``SegmentBundleSampler``: per-2D-segment bundles for the grouping loss.
Batches are fixed-size and padded, with validity masks. The bundles'
permutations are numpy's, made natively on the same stream where they can
be (``data/shuffle.py``). Each draw runs in the span ``train.sample``
(``utils/observability.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..utils.observability import span
from . import shuffle


@dataclass
class SegmentationData:
    """Scene-level class bookkeeping (reference: dataset/base.py:20-37)."""
    fg_classes: List[int]
    bg_classes: List[int]
    num_semantic_classes: int
    instance_to_semantics: Dict[int, int] = field(default_factory=dict)
    num_instances: int = 0


@dataclass
class FrameData:
    """Everything known about one posed frame, already resized to image_dim."""
    name: str
    rays: np.ndarray          # [H*W, 8]
    rgbs: np.ndarray          # [H*W, 3]
    semantics: np.ndarray     # [H*W] int — machine labels (m2f/detic)
    instances: np.ndarray     # [H*W] int — machine instance ids (frame-local)
    probabilities: np.ndarray  # [H*W, C]
    confidences: np.ndarray   # [H*W]
    mask: np.ndarray          # [H*W] bool (valid pixels)
    feats: Optional[np.ndarray] = None   # [H*W, 64] distilled targets
    gt_semantics: Optional[np.ndarray] = None  # [H*W] GT for eval ("rs_*")
    gt_instances: Optional[np.ndarray] = None
    intrinsics: Optional[np.ndarray] = None
    cam2normscene: Optional[np.ndarray] = None
    depth: Optional[np.ndarray] = None
    segments: Optional[np.ndarray] = None  # [H*W] 2D segment ids (m2f_segments)


@dataclass
class SceneData:
    train_frames: List[FrameData]
    val_frames: List[FrameData]
    segmentation: SegmentationData
    image_dim: tuple
    scene_bounds: np.ndarray = field(
        default_factory=lambda: np.array([[-1., -1., -1.], [1., 1., 1.]], np.float32))
    white_bg: bool = False
    things_filtered: set = field(default_factory=set)
    stuff_filtered: set = field(default_factory=set)
    faulty_classes: set = field(default_factory=lambda: {0})

    @property
    def num_semantic_classes(self) -> int:
        return self.segmentation.num_semantic_classes


class RayPoolSampler:
    """Stream 0: uniform i.i.d. batches from the flat train-ray pool."""

    def __init__(self, frames: List[FrameData], num_classes: int,
                 load_feats: bool = False, load_depth: bool = False):
        self.rays = np.concatenate([f.rays for f in frames]).astype(np.float32)
        self.rgbs = np.concatenate([f.rgbs for f in frames]).astype(np.float32)
        self.semantics = np.concatenate([f.semantics for f in frames]).astype(np.int32)
        self.probabilities = np.concatenate(
            [f.probabilities for f in frames]).astype(np.float32)
        self.confidences = np.concatenate([f.confidences for f in frames]).astype(np.float32)
        self.mask = np.concatenate([f.mask for f in frames]).astype(bool)
        self.feats = (np.concatenate([f.feats for f in frames]).astype(np.float32)
                      if load_feats and frames[0].feats is not None else None)
        self.depth = (np.concatenate([f.depth for f in frames]).astype(np.float32)
                      if load_depth and frames[0].depth is not None else None)
        self.n = self.rays.shape[0]

    def sample(self, rng: np.random.Generator, batch_size: int) -> dict:
        with span("train.sample"):
            from .native import gather_rows
            idx = rng.integers(0, self.n, batch_size)
            batch = {
                "rays": gather_rows(self.rays, idx),
                "rgbs": gather_rows(self.rgbs, idx),
                "semantics": self.semantics[idx],
                "probabilities": gather_rows(self.probabilities, idx),
                "confidences": self.confidences[idx],
                "mask": self.mask[idx],
            }
            if self.feats is not None:
                batch["feats"] = gather_rows(self.feats, idx)
            if self.depth is not None:
                batch["depth"] = self.depth[idx]
            return batch


class InstanceBundleSampler:
    """Stream 1: per-image ray bundles at labeled-instance pixels.

    Emits [I, R, ...] arrays with per-image label compaction to [0, max_labels)
    and validity masks (reference: dataset/panopli.py:273-324 ragged collate ->
    fixed-size padded batches).
    """

    def __init__(self, frames: List[FrameData], max_rays: int = 1024,
                 max_labels: int = 128, use_gt_instances: bool = False):
        self.max_rays = max_rays
        self.max_labels = max_labels
        self.per_image = []
        for f in frames:
            inst = f.gt_instances if use_gt_instances else f.instances
            sel = np.where((inst > 0) & f.mask)[0]
            if sel.size == 0:
                continue
            self.per_image.append({
                "rays": f.rays[sel].astype(np.float32),
                "labels": inst[sel].astype(np.int64),
                "confidences": f.confidences[sel].astype(np.float32),
            })
        if not self.per_image:
            raise ValueError("Empty instance dataset")

    def sample(self, rng: np.random.Generator, num_images: int) -> dict:
        with span("train.sample"):
            picks = rng.integers(0, len(self.per_image), num_images)
            R = self.max_rays
            rays = np.zeros((num_images, R, 8), np.float32)
            labels = np.zeros((num_images, R), np.int32)
            confs = np.zeros((num_images, R), np.float32)
            valid = np.zeros((num_images, R), bool)
            # per image, in this order: a permutation of its rays, whose
            # first R are taken, then one of the bundle's R slots
            perms = shuffle.heads(rng, [n for p in picks for n in (
                self.per_image[p]["rays"].shape[0], R)], R)
            for i, p in enumerate(picks):
                img = self.per_image[p]
                take = perms[2 * i]
                k = take.size
                rays[i, :k] = img["rays"][take]
                confs[i, :k] = img["confidences"][take]
                valid[i, :k] = True
                # compact labels to [0, max_labels); overflow labels fold
                # together
                raw = img["labels"][take]
                _, compact = np.unique(raw, return_inverse=True)
                labels[i, :k] = np.minimum(compact, self.max_labels - 1)
                # shuffle within the bundle so the fast/slow half-split is
                # random
                perm = perms[2 * i + 1]
                rays[i], labels[i] = rays[i][perm], labels[i][perm]
                confs[i], valid[i] = confs[i][perm], valid[i][perm]
            return {"rays": rays, "labels": labels, "confidences": confs,
                    "valid": valid}


class SegmentBundleSampler:
    """Stream 2: per-2D-segment ray bundles for the grouping loss.

    A "segment" is one (frame, machine-instance-id) region; each batch holds
    ``batch_size_segments`` segments of up to ``max_rays`` rays each, flattened
    with group ids == segment slot (reference: dataset/panopli.py:372-432).
    """

    def __init__(self, frames: List[FrameData], max_rays: int = 1024):
        self.max_rays = max_rays
        self.segments = []
        for f in frames:
            seg_map = f.segments if f.segments is not None else f.instances
            for seg_id in np.unique(seg_map):
                if seg_id <= 0:
                    continue
                sel = np.where((seg_map == seg_id) & f.mask)[0]
                if sel.size < 4:
                    continue
                self.segments.append({
                    "rays": f.rays[sel].astype(np.float32),
                    "confidences": f.confidences[sel].astype(np.float32),
                })

    def __len__(self):
        return len(self.segments)

    def sample(self, rng: np.random.Generator, num_segments: int) -> dict:
        with span("train.sample"):
            picks = rng.integers(0, len(self.segments), num_segments)
            R = self.max_rays
            rays = np.zeros((num_segments * R, 8), np.float32)
            group = np.zeros((num_segments * R,), np.int32)
            confs = np.zeros((num_segments * R,), np.float32)
            valid = np.zeros((num_segments * R,), bool)
            takes = shuffle.heads(
                rng, [self.segments[p]["rays"].shape[0] for p in picks], R)
            for i, (p, take) in enumerate(zip(picks, takes)):
                seg = self.segments[p]
                k = take.size
                lo = i * R
                rays[lo:lo + k] = seg["rays"][take]
                confs[lo:lo + k] = seg["confidences"][take]
                group[lo:lo + R] = i
                valid[lo:lo + k] = True
            return {"rays": rays, "group": group, "confidences": confs,
                    "valid": valid}
