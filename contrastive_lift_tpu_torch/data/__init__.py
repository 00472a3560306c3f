"""Dataset dispatch: the port's copy of ``contrastive_lift_tpu/data/__init__.py``.

``load_scene`` builds the scene of ``cfg.dataset_class``: ``panopli``
(``data/panopli.py``: JPEG colour, PNG labels), ``mos`` (``data/mos.py``:
PNG colour, npy labels) or ``synthetic`` (``data/synthetic.py``). The
readers decode and resize their images without PIL (``utils/jpeg.py``,
``utils/png.py``, ``utils/image.py``).
"""
from __future__ import annotations

from pathlib import Path

from .base import SceneData


def load_scene(cfg, split_dims=None, load_train: bool = True,
               load_val: bool = True, use_gt_inssem: bool = False) -> SceneData:
    """The SceneData of ``cfg.dataset_class`` at ``cfg.image_dim`` (or
    ``split_dims``).

    ``use_gt_inssem`` switches the machine labels (m2f/detic) for the GT
    labels, like the reference's get_dataset(use_gt_inssem=True)."""
    image_dim = split_dims or cfg.image_dim
    from . import native
    native.set_num_threads(getattr(cfg, "num_workers", 0))
    if cfg.dataset_class == "panopli":
        from .panopli import PanopLiSceneReader
        sem_dir, inst_dir, key = (("rs_semantics", "rs_instance",
                                   "rs_instance_to_semantic") if use_gt_inssem
                                  else ("m2f_semantics", "m2f_instance",
                                        "m2f_instance_to_semantic"))
        reader = PanopLiSceneReader(
            Path(cfg.dataset_root), image_dim, cfg.max_depth,
            semantics_dir=sem_dir, instance_dir=inst_dir,
            instance_to_semantic_key=key,
            load_feat=(cfg.use_distilled_features_semantic
                       or cfg.use_distilled_features_instance),
            feature_type=cfg.feature_type,
            subsample_frames=cfg.subsample_frames, overfit=cfg.overfit)
        return reader.load_scene(load_train, load_val)
    if cfg.dataset_class == "mos":
        from .mos import MOSSceneReader
        sem_dir, inst_dir = (("semantic", "instance") if use_gt_inssem
                             else ("detic_semantic", "detic_instance"))
        reader = MOSSceneReader(
            Path(cfg.dataset_root), image_dim, cfg.max_depth,
            semantics_dir=sem_dir, instance_dir=inst_dir,
            subsample_frames=cfg.subsample_frames, overfit=cfg.overfit)
        return reader.load_scene(load_train, load_val)
    if cfg.dataset_class == "synthetic":
        from .synthetic import make_synthetic_scene
        return make_synthetic_scene(image_dim=tuple(image_dim),
                                    seed=cfg.seed or 0)
    raise NotImplementedError(cfg.dataset_class)
