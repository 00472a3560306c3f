"""3D bounding-box importers: annotation dumps -> ``segmentation_data.pkl``.
The port's copy of ``contrastive_lift_tpu/data/preprocessing/bboxes.py``.

Capability match for the reference's GT / detector box ingestion
(reference: dataset/preprocessing/preprocess_scannet.py:519-593):

* ``import_gt_bboxes`` reads the ScanNet-export ``<scene>_bbox.npy``
  (rows = [cx, cy, cz, ex, ey, ez, label_id, instance_id]) and stores the
  thing-class boxes under ``gt_bboxes`` (:519-547).
* ``import_mmdet_bboxes`` reads an ImVoxelNet/mmdet-style JSON list of
  ``{"corners": [8x3], "label": str}`` detections and stores them under
  ``mmdet_bboxes`` (:550-592).

Both write the reference's box schema — ``{"position": [3], "orientation":
[3,3], "extent": [3], "class": int}`` — which is exactly what the scene
editors consume (renderer/editing.py, inference/bboxes.py). Scene-specific
annotation overrides (the reference's hardcoded
``scene_specific_fixes_objectid`` / ``mmdet_export_fixes`` tables,
preprocess_scannet.py:109-186) are taken as per-call parameters instead of a
baked-in scene table. Optional ``.obj`` wireframe dumps mirror the
reference's ``visualized_gtboxes`` / ``visualized_mmdetboxes`` folders
without the trimesh dependency.
"""
from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .m2f import RESOURCES, load_class_names, load_thing_flags

# Unit-cube triangle faces (1-indexed, OBJ convention); vertices are the 8
# corner sign combinations in _box_corners order.
_BOX_FACES = [
    (1, 3, 4), (1, 4, 2), (5, 8, 7), (5, 6, 8),  # -x / +x
    (1, 2, 6), (1, 6, 5), (3, 8, 4), (3, 7, 8),  # -y / +y
    (1, 7, 3), (1, 5, 7), (2, 4, 8), (2, 8, 6),  # -z / +z
]


def _box_corners(position, extent, orientation) -> np.ndarray:
    """[8,3] world-space corners of an oriented box."""
    half = np.asarray(extent, np.float64) / 2.0
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], np.float64)
    local = signs * half
    return local @ np.asarray(orientation, np.float64).T + np.asarray(
        position, np.float64)


def write_box_obj(path, position, extent, orientation) -> None:
    """Minimal OBJ box mesh (the reference exports trimesh ``create_box``
    meshes for eyeballing annotation alignment; geometry is what matters)."""
    corners = _box_corners(position, extent, orientation)
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in corners]
    lines += [f"f {a} {b} {c}" for a, b, c in _BOX_FACES]
    Path(path).write_text("\n".join(lines) + "\n")


def _update_segmentation_data(scene_dir: Path, key: str, bboxes: dict) -> None:
    pkl_path = Path(scene_dir) / "segmentation_data.pkl"
    with open(pkl_path, "rb") as f:
        data = pickle.load(f)
    data[key] = bboxes
    with open(pkl_path, "wb") as f:
        pickle.dump(data, f)


def import_gt_bboxes(bbox_npy_path, scene_dir, raw_to_reduced: Dict[int, int],
                     object_id_fixes: Optional[Dict[int, int]] = None,
                     class_set: str = "reduced", visualize: bool = False,
                     resources_dir=None) -> dict:
    """ScanNet GT box dump -> ``gt_bboxes`` in segmentation_data.pkl.

    ``raw_to_reduced`` folds the dump's raw label ids to the reduced class
    set (the reference composes its reduce+fold maps,
    preprocess_scannet.py:520,536); ``object_id_fixes`` maps instance id ->
    corrected raw label id for scenes with bad annotations (:533-535, the
    per-scene fix table as a parameter). Boxes keep axis-aligned identity
    orientation; only thing-class boxes are kept (:537)."""
    scene_dir = Path(scene_dir)
    thing_flags = load_thing_flags(class_set, resources_dir)
    annot = np.load(Path(bbox_npy_path))
    if annot.ndim != 2 or annot.shape[1] < 8:
        raise ValueError(f"expected [N, 8] bbox rows, got {annot.shape}")
    fixes = object_id_fixes or {}
    bboxes = {}
    vis_dir = scene_dir / "visualized_gtboxes"
    if visualize:
        vis_dir.mkdir(exist_ok=True)
    for row in annot:
        position = np.asarray(row[0:3], np.float32)
        extent = np.asarray(row[3:6], np.float32)
        # the dump's instance ids are 0-based; scene ids are 1-based (:532)
        instance_id = int(row[7]) + 1
        raw_label = fixes.get(instance_id, int(row[6]))
        label = int(raw_to_reduced.get(raw_label, 0))
        if not (0 <= label < len(thing_flags)) or not thing_flags[label]:
            continue
        box_id = len(bboxes)
        bboxes[box_id] = {"position": position, "orientation": np.eye(3),
                          "extent": extent, "class": label}
        if visualize:
            write_box_obj(vis_dir / f"{label}_{box_id}.obj", position, extent,
                          np.eye(3))
    _update_segmentation_data(scene_dir, "gt_bboxes", bboxes)
    return bboxes


def load_mmdet_label_map(class_set: str = "reduced",
                         resources_dir=None) -> Dict[str, str]:
    """mmdet/ImVoxelNet class name -> reduced class name (data table; the
    reference ships the same mapping as
    resources/scannet_mmdet_to_scannet_reduced.csv)."""
    root = Path(resources_dir) if resources_dir else RESOURCES
    out = {}
    for line in (root / f"scannet_mmdet_to_{class_set}.csv").read_text() \
            .strip().splitlines():
        src, dst = line.split(",")[:2]
        out[src.strip()] = dst.strip()
    return out


def import_mmdet_bboxes(bboxes_json_path, scene_dir,
                        label_map: Optional[Dict[str, str]] = None,
                        export_fix: Optional[dict] = None,
                        class_set: str = "reduced", visualize: bool = False,
                        resources_dir=None) -> dict:
    """ImVoxelNet/mmdet detection JSON -> ``mmdet_bboxes``.

    Detections are ``{"corners": [8x3], "label": name}``; corners are
    reduced to an axis-aligned position/extent exactly as the reference does
    (min/max over corners, preprocess_scannet.py:575-578). ``export_fix``
    optionally undoes the detector's export frame: a dict with ``rotation``
    ([angle, ax, ay, az] axis-angle or a [3,3] matrix), ``translation`` [3],
    and ``scale`` scalar — corners are premultiplied by
    ``inv(T @ S @ R)`` (:566-574, the per-scene fix table as a parameter)."""
    scene_dir = Path(scene_dir)
    thing_flags = load_thing_flags(class_set, resources_dir)
    names = load_class_names(class_set, resources_dir)
    if label_map is None:
        label_map = load_mmdet_label_map(class_set, resources_dir)
    fix_inv = None
    if export_fix is not None:
        rot4 = np.eye(4)
        rot = export_fix.get("rotation")
        if rot is not None:
            rot = np.asarray(rot, np.float64)
            if rot.shape == (3, 3):
                rot4[:3, :3] = rot
            else:  # [angle, axis] axis-angle, Rodrigues
                angle, axis = float(rot[0]), rot[1:4]
                axis = axis / np.linalg.norm(axis)
                kx = np.array([[0, -axis[2], axis[1]],
                               [axis[2], 0, -axis[0]],
                               [-axis[1], axis[0], 0]])
                rot4[:3, :3] = (np.eye(3) + np.sin(angle) * kx
                                + (1 - np.cos(angle)) * (kx @ kx))
        tr4 = np.eye(4)
        tr4[:3, 3] = np.asarray(export_fix.get("translation", (0, 0, 0)))
        sc4 = np.eye(4)
        sc4[:3, :3] *= float(export_fix.get("scale", 1.0))
        fix_inv = np.linalg.inv(tr4 @ sc4 @ rot4)
    detections = json.loads(Path(bboxes_json_path).read_text())
    bboxes = {}
    vis_dir = scene_dir / "visualized_mmdetboxes"
    if visualize:
        vis_dir.mkdir(exist_ok=True)
    for det in detections:
        corners = np.asarray(det["corners"], np.float64)
        if fix_inv is not None:
            corners = corners @ fix_inv[:3, :3].T + fix_inv[:3, 3]
        cmin, cmax = corners.min(axis=0), corners.max(axis=0)
        mapped = label_map.get(str(det["label"]).lower())
        if mapped is None or mapped not in names:
            continue
        label = names.index(mapped)
        if not thing_flags[label]:
            continue
        box_id = len(bboxes)
        bboxes[box_id] = {
            "position": ((cmax + cmin) / 2).astype(np.float32),
            "orientation": np.eye(3),
            "extent": (cmax - cmin).astype(np.float32),
            "class": label,
        }
        if visualize:
            write_box_obj(vis_dir / f"{label}_{box_id}.obj",
                          bboxes[box_id]["position"],
                          bboxes[box_id]["extent"], np.eye(3))
    _update_segmentation_data(scene_dir, "mmdet_bboxes", bboxes)
    return bboxes


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--scene_dir", required=True)
    parser.add_argument("--mode", choices=["gt", "mmdet"], required=True)
    parser.add_argument("--bbox_path", required=True,
                        help="<scene>_bbox.npy (gt) or detections JSON (mmdet)")
    parser.add_argument("--raw_to_reduced", default=None,
                        help="JSON/TSV raw-label -> reduced-class mapping "
                             "(gt mode; see scannet.load_raw_to_reduced)")
    parser.add_argument("--class_set", default="reduced")
    parser.add_argument("--visualize", action="store_true")
    args = parser.parse_args(argv)
    if args.mode == "gt":
        from .scannet import load_raw_to_reduced
        if args.raw_to_reduced is None:
            # an empty mapping folds EVERY raw label to void, drops every
            # box, and would silently overwrite a previously valid
            # gt_bboxes with {} — refuse instead
            parser.error("--mode gt requires --raw_to_reduced (raw label id "
                         "-> reduced class id mapping)")
        boxes = import_gt_bboxes(args.bbox_path, args.scene_dir,
                                 load_raw_to_reduced(args.raw_to_reduced),
                                 class_set=args.class_set,
                                 visualize=args.visualize)
    else:
        boxes = import_mmdet_bboxes(args.bbox_path, args.scene_dir,
                                    class_set=args.class_set,
                                    visualize=args.visualize)
    print(f"imported {len(boxes)} thing boxes")


if __name__ == "__main__":
    main()
