"""Scene data containers (host-side numpy): the port's copy of
``contrastive_lift_tpu/data/base.py``'s ``SegmentationData``, ``FrameData``
and ``SceneData``. The batch samplers belong to training, a later slice."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


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
