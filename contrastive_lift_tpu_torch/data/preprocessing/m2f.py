"""Raw Mask2Former/Detic panoptic dumps -> m2f_* machine-label layout: the
port's copy of ``contrastive_lift_tpu/data/preprocessing/m2f.py``.

Converts per-frame raw panoptic predictions (an id mask plus a segment
table, with and without test-time augmentation (TTA), plus fused class
probabilities) into the m2f_semantics / m2f_instance / m2f_notta_* /
m2f_invalid / m2f_segments / m2f_probabilities folders the scene readers
consume, and records instance->semantic tables in segmentation_data.pkl.

Input dump formats per frame (``panoptic/<name>.<ext>``):
  * ``.ptz``  gzip'd torch pickle:
                {'mask', 'segments', 'mask_notta', 'segments_notta',
                 'probabilities', 'confidences', 'confidences_notta'}
  * ``.pt``   the same, uncompressed
  * ``.npz``  arrays 'mask', 'mask_notta', 'probabilities', 'confidences',
              'confidences_notta' + JSON-encoded 'segments' /
              'segments_notta' (list of {id, category_id, [category_name]})
              stored as a string array.

Class mapping: segments carry either scannet-reduced ``category_id``s
directly, or COCO ``category_name``s folded to the reduced set through
``resources/scannet_reduced_to_coco.csv`` (the port's copy of the table).
The PNGs are written by ``utils/png.py`` (16-bit grey ids, 8-bit masks).
"""
from __future__ import annotations

import gzip
import json
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...utils.png import write_png

RESOURCES = Path(__file__).resolve().parents[2] / "resources"


# ---------------------------------------------------------------------------
# Class tables
# ---------------------------------------------------------------------------

def load_coco_to_scannet(sc_classes: str = "reduced",
                         resources_dir=None) -> Dict[str, int]:
    """COCO panoptic category name -> scannet-<sc_classes> id (1-based; 0 is
    void). Reference: preprocess_scannet.py:430-435 — csv line i maps every
    listed 'supercategory/name' entry to class i+1; the key is the part
    after '/'."""
    root = Path(resources_dir) if resources_dir else RESOURCES
    mapping: Dict[str, int] = {}
    text = (root / f"scannet_{sc_classes}_to_coco.csv").read_text()
    for cidx, line in enumerate(text.strip().splitlines()):
        cols = [c.strip() for c in line.split(",")]
        for entry in cols[1:]:
            mapping[entry.split("/")[1]] = cidx + 1
    return mapping


def load_thing_flags(sc_classes: str = "reduced",
                     resources_dir=None) -> List[bool]:
    """[False(void)] + per-class thing flags.
    Reference: preprocess_scannet.py:285-289."""
    root = Path(resources_dir) if resources_dir else RESOURCES
    text = (root / f"scannet_{sc_classes}_things.csv").read_text()
    flags = [False]
    for line in text.strip().splitlines():
        flags.append(bool(int(line.split(",")[1])))
    return flags


def load_class_names(sc_classes: str = "reduced",
                     resources_dir=None) -> List[str]:
    """["void"] + class names. Reference: preprocess_scannet.py:292-296."""
    root = Path(resources_dir) if resources_dir else RESOURCES
    text = (root / f"scannet_{sc_classes}_things.csv").read_text()
    return ["void"] + [line.split(",")[0] for line in text.strip().splitlines()]


# ---------------------------------------------------------------------------
# Per-frame conversion
# ---------------------------------------------------------------------------

def convert_panoptic_mask(mask: np.ndarray, segments: Sequence[dict],
                          thing_flags: Sequence[bool], instance_ctr: int,
                          instance_to_semantic: Dict[int, int],
                          coco_to_scannet: Optional[Dict[str, int]] = None,
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     int, Dict[int, int]]:
    """One raw panoptic frame -> (semantics, instances, invalid, ctr, table).

    With ``coco_to_scannet`` the segment's ``category_name`` is folded to the
    reduced set (reference convert_from_mask_to_semantics_and_instances,
    :403-414; unmapped categories stay void and spawn no instance);
    without it the segment's ``category_id`` is used directly
    (`..._no_remap`, :417-426). Instance ids increment scene-wide across
    calls; invalid = pixels with segment id 0 (no prediction).
    """
    mask = np.asarray(mask, np.int64)
    max_id = int(mask.max(initial=0))
    sem_lut = np.zeros(max(1024, max_id + 1), np.int32)
    inst_lut = np.zeros(max(1024, max_id + 1), np.int32)
    for seg in segments:
        sid = int(seg["id"])
        if coco_to_scannet is not None:
            name = seg.get("category_name")
            if name not in coco_to_scannet:
                continue
            cls = coco_to_scannet[name]
        else:
            cls = int(seg["category_id"])
        sem_lut[sid] = cls
        if cls < len(thing_flags) and thing_flags[cls]:
            inst_lut[sid] = instance_ctr
            instance_to_semantic[instance_ctr] = cls
            instance_ctr += 1
    semantics = sem_lut[mask]
    instances = inst_lut[mask]
    invalid = mask == 0
    return semantics, instances, invalid, instance_ctr, instance_to_semantic


def segment_ids_frame(mask: np.ndarray, segments: Sequence[dict],
                      segment_ctr: int) -> Tuple[np.ndarray, int]:
    """Scene-wide unique 2D segment ids for the grouping loss
    (reference :479-484)."""
    mask = np.asarray(mask, np.int64)
    lut = np.zeros(max(1024, int(mask.max(initial=0)) + 1), np.int32)
    for seg in segments:
        lut[int(seg["id"])] = segment_ctr
        segment_ctr += 1
    return lut[mask], segment_ctr


# ---------------------------------------------------------------------------
# Dump loading
# ---------------------------------------------------------------------------

def _to_numpy(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def load_panoptic_dump(path) -> dict:
    """Load one raw panoptic dump (.ptz / .pt / .npz) into numpy."""
    path = Path(path)
    if path.suffix == ".npz":
        npz = np.load(path, allow_pickle=False)
        out = {k: np.asarray(npz[k]) for k in
               ("mask", "mask_notta", "probabilities", "confidences",
                "confidences_notta") if k in npz}
        for key in ("segments", "segments_notta"):
            if key in npz:
                out[key] = json.loads(str(npz[key]))
        return out
    if path.suffix == ".ptz":
        with gzip.open(path) as f:
            data = torch.load(f, map_location="cpu", weights_only=False)
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
    out = {}
    for key, value in data.items():
        out[key] = value if isinstance(value, list) else _to_numpy(value)
    return out


# ---------------------------------------------------------------------------
# Conversion of a whole scene
# ---------------------------------------------------------------------------

def map_panoptic_outputs(scene_dir, dumps_dir=None,
                         sc_classes: str = "reduced",
                         use_coco_remap: bool = False,
                         resources_dir=None, frame_names=None) -> dict:
    """Convert every raw dump under ``<scene>/panoptic/`` (or
    ``dumps_dir``) into the m2f_* layout inside ``scene_dir``.

    Returns the instance->semantic tables written to segmentation_data.pkl.
    """
    scene = Path(scene_dir)
    dumps = Path(dumps_dir) if dumps_dir else scene / "panoptic"
    thing_flags = load_thing_flags(sc_classes, resources_dir)
    coco_map = (load_coco_to_scannet(sc_classes, resources_dir)
                if use_coco_remap else None)
    for sub in ("m2f_instance", "m2f_semantics", "m2f_notta_instance",
                "m2f_notta_semantics", "m2f_probabilities", "m2f_invalid",
                "m2f_segments"):
        (scene / sub).mkdir(parents=True, exist_ok=True)

    if frame_names is None:
        color = scene / "color"
        if color.exists():
            frame_names = sorted(p.stem for p in color.iterdir())
        else:
            frame_names = sorted({p.stem for p in dumps.iterdir()})

    ctr, ctr_notta, seg_ctr = 1, 1, 1
    inst_to_sem: Dict[int, int] = {}
    inst_to_sem_notta: Dict[int, int] = {}
    for name in frame_names:
        dump_path = next((p for ext in (".ptz", ".pt", ".npz")
                          for p in [dumps / f"{name}{ext}"] if p.exists()),
                         None)
        if dump_path is None:
            raise FileNotFoundError(
                f"no panoptic dump for frame '{name}' under {dumps} "
                "(expected .ptz/.pt/.npz)")
        data = load_panoptic_dump(dump_path)

        sem, inst, invalid, ctr, inst_to_sem = convert_panoptic_mask(
            data["mask"], data["segments"], thing_flags, ctr, inst_to_sem,
            coco_map)
        sem_nt, inst_nt, _, ctr_notta, inst_to_sem_notta = convert_panoptic_mask(
            data["mask_notta"], data["segments_notta"], thing_flags,
            ctr_notta, inst_to_sem_notta, coco_map)
        seg_map, seg_ctr = segment_ids_frame(data["mask"], data["segments"],
                                             seg_ctr)

        for sub, ids in (("m2f_segments", seg_map), ("m2f_semantics", sem),
                         ("m2f_instance", inst),
                         ("m2f_notta_semantics", sem_nt),
                         ("m2f_notta_instance", inst_nt)):
            write_png(scene / sub / f"{name}.png", ids.astype(np.uint16))
        write_png(scene / "m2f_invalid" / f"{name}.png",
                  invalid.astype(np.uint8) * 255)
        np.savez_compressed(
            scene / "m2f_probabilities" / f"{name}.npz",
            probability=np.asarray(data["probabilities"], np.float32),
            confidence=np.asarray(data["confidences"], np.float32),
            confidence_notta=np.asarray(data["confidences_notta"], np.float32))

    seg_pkl = scene / "segmentation_data.pkl"
    export = (pickle.loads(seg_pkl.read_bytes()) if seg_pkl.exists() else {})
    export["m2f_instance_to_semantic"] = inst_to_sem
    # the reference stores the TTA table under the notta key too (:513-514)
    export["m2f_notta_instance_to_semantic"] = inst_to_sem
    seg_pkl.write_bytes(pickle.dumps(export))
    return {"m2f_instance_to_semantic": inst_to_sem,
            "m2f_notta_instance_to_semantic": inst_to_sem_notta}


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="Convert raw Mask2Former panoptic dumps to m2f_* layout")
    parser.add_argument("scene", type=str)
    parser.add_argument("--dumps_dir", type=str, default=None)
    parser.add_argument("--sc_classes", type=str, default="reduced")
    parser.add_argument("--coco_remap", action="store_true",
                        help="fold COCO category names via the csv table "
                             "instead of using category_id directly")
    parser.add_argument("--resources_dir", type=str, default=None)
    args = parser.parse_args(argv)
    tables = map_panoptic_outputs(args.scene, args.dumps_dir, args.sc_classes,
                                  args.coco_remap, args.resources_dir)
    print(json.dumps({k: len(v) for k, v in tables.items()}))


if __name__ == "__main__":
    main()
