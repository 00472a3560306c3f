"""Checkpoints: the JAX package's flat-npz format, with optimizer state.

Port of ``contrastive_lift_tpu/io/checkpoint.py``. A checkpoint is one
``.npz`` of pytree leaves keyed by their slash-joined path
(``density/planes/0``, ``appearance_mlp/layers/1/w``, ...) plus a JSON
``__meta__`` blob with ``grid_dim``, ``bbox_aabb``, epoch and step, so the
model is rebuilt directly at the stored resolution. Both packages read and
write the same files (``format_version`` 2).

The optimizer state is stored as ``__opt__NNNNN`` leaves in optax's flat
order of the pair (main chain, instance chain). Each chain is a
``multi_transform`` whose groups flatten in sorted label order; an Adam
group contributes its ``count``, then ``mu`` and ``nu`` of its own leaves
(in parameter order); a ``set_to_zero`` group contributes nothing.
``opt_state_from_leaves`` and ``opt_state_leaves`` map between that list and
the port's ``train/state.py`` Adam state.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.tree import path_str, tree_leaves_with_path


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
    Stored optimizer leaves, in order, are ``metadata["opt_leaves"]``."""
    with np.load(Path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = {k: data[k] for k in data.files
                if k != "__meta__" and not k.startswith("__opt__")}
        opt_keys = sorted(k for k in data.files if k.startswith("__opt__"))
        if opt_keys:
            meta["opt_leaves"] = [data[k] for k in opt_keys]
    params = _unflatten_from_paths(flat)
    return params, meta


def opt_state_leaves(opt_main: dict, opt_inst: dict) -> list:
    """The optimizer state of both chains as optax's flat leaf list."""
    leaves = []
    for state in (opt_main, opt_inst):
        for label in sorted(state):
            st = state[label]
            leaves.append(st.count)
            leaves.extend(st.mu.values())
            leaves.extend(st.nu.values())
    return leaves


def opt_state_from_leaves(main_tx, inst_tx, opt_leaves, params: dict,
                          device="cpu"):
    """(opt_main, opt_inst) of the port's Adam chains from stored leaves;
    shapes are checked against ``params`` (rebuild the model at the
    checkpoint's grid first)."""
    from ..train.state import AdamState
    shapes = {p: tuple(t.shape) for p, t in tree_leaves_with_path(params)}
    it = iter(opt_leaves)
    n_expected = sum(1 + 2 * len(tx.paths(label))
                     for tx in (main_tx, inst_tx) for label in tx.groups)
    if len(opt_leaves) != n_expected:
        raise ValueError(
            f"optimizer state leaf count mismatch: checkpoint has "
            f"{len(opt_leaves)}, the chains need {n_expected} (the config "
            "or optimizer setup changed since the checkpoint was saved)")

    def take(path):
        leaf = np.asarray(next(it))
        if path is not None and leaf.shape != shapes[path]:
            raise ValueError(
                f"optimizer leaf shape mismatch at {path_str(path)}: "
                f"{leaf.shape} vs {shapes[path]} — rebuild the model at the "
                "checkpoint grid_dim before restoring")
        return torch.as_tensor(leaf, device=device)

    states = []
    for tx in (main_tx, inst_tx):
        state = {}
        for label in sorted(tx.groups):
            paths = tx.paths(label)
            count = take(None)
            mu = {p: take(p) for p in paths}
            nu = {p: take(p) for p in paths}
            state[label] = AdamState(count, mu, nu)
        states.append(state)
    return tuple(states)


def save_checkpoint(path, params, *, grid_dim, bbox_aabb, epoch: int,
                    global_step: int, config_dict: Optional[dict] = None,
                    extra: Optional[dict] = None, opt_state=None) -> None:
    """Params + geometry metadata, optionally with the optimizer state
    ``(opt_main, opt_inst)``, in the layout the JAX package's loader reads
    back."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {path_str(p): np.asarray(torch.as_tensor(t).detach().cpu())
            for p, t in tree_leaves_with_path(params)}
    n_opt = 0
    if opt_state is not None:
        leaves = opt_state_leaves(*opt_state)
        for i, leaf in enumerate(leaves):
            flat[f"__opt__{i:05d}"] = np.asarray(leaf.detach().cpu())
        n_opt = len(leaves)
    meta = {
        "grid_dim": [int(g) for g in grid_dim],
        "bbox_aabb": np.asarray(bbox_aabb).tolist(),
        "epoch": int(epoch),
        "global_step": int(global_step),
        "config": config_dict or {},
        "extra": extra or {},
        "n_opt_leaves": n_opt,
        "format_version": 2,
    }
    np.savez_compressed(path, __meta__=json.dumps(meta), **flat)
