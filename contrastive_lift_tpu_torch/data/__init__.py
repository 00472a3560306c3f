"""Dataset dispatch: the port's copy of ``contrastive_lift_tpu/data/__init__.py``.

Only the synthetic scene is ported. The PanopLi and MOS readers decode their
images with PIL, which the card's machine does not have; they wait for a
PIL-free decoder (ROADMAP slice 1c).
"""
from __future__ import annotations

from .base import SceneData


def load_scene(cfg, split_dims=None, load_train: bool = True,
               load_val: bool = True, use_gt_inssem: bool = False) -> SceneData:
    """The SceneData of ``cfg.dataset_class`` at ``cfg.image_dim`` (or
    ``split_dims``)."""
    image_dim = split_dims or cfg.image_dim
    from . import native
    native.set_num_threads(getattr(cfg, "num_workers", 0))
    if cfg.dataset_class in ("panopli", "mos"):
        raise NotImplementedError(
            f"dataset_class={cfg.dataset_class!r}: the reader is not ported "
            "yet; it waits for PIL-free image decoding (ROADMAP slice 1c)")
    if cfg.dataset_class == "synthetic":
        from .synthetic import make_synthetic_scene
        return make_synthetic_scene(image_dim=tuple(image_dim),
                                    seed=cfg.seed or 0)
    raise NotImplementedError(cfg.dataset_class)
