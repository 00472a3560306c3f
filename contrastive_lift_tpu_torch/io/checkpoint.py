"""Checkpoint loading (numpy only): the JAX package's flat-npz format.

Port of the load side of ``contrastive_lift_tpu/io/checkpoint.py``. A
checkpoint is one ``.npz`` of pytree leaves keyed by their slash-joined path
(``density/planes/0``, ``appearance_mlp/layers/1/w``, ...) plus a JSON
``__meta__`` blob with ``grid_dim``, ``bbox_aabb``, epoch and step, so the
model is rebuilt directly at the stored resolution. Both packages read the
same files.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np


def _unflatten_from_paths(flat: dict) -> dict:
    """Rebuild a nested dict/tuple-free pytree from path keys.

    Integer path components become list indices; everything else dict keys.
    Lists are converted to tuples at the end only for 'planes'/'lines' (the
    factor-grid containers), matching init_tensorf's structure.
    """
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def normalize(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            seq = [normalize(node[str(i)]) for i in range(len(keys))]
            return seq
        return {k: normalize(v) for k, v in node.items()}

    out = normalize(root)

    def tupleize(node):
        if isinstance(node, dict):
            return {k: (tuple(tupleize(x) for x in v)
                        if k in ("planes", "lines") and isinstance(v, list)
                        else tupleize(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [tupleize(x) for x in node]
        return node

    return tupleize(out)


def load_checkpoint(path) -> Tuple[dict, dict]:
    """Returns (params, metadata): numpy leaves at the stored grid shapes.

    The optimizer leaves (``__opt__*``) are skipped: they serve resuming a
    training run, which is not ported yet."""
    with np.load(Path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = {k: data[k] for k in data.files
                if k != "__meta__" and not k.startswith("__opt__")}
    params = _unflatten_from_paths(flat)
    return params, meta
