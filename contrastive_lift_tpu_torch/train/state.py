"""Train state: parameter groups and the two Adam chains, as plain functions.

Port of ``contrastive_lift_tpu/train/state.py``. The reference trains with
two Adam optimizers: the main one (betas 0.9/0.99) over the density,
appearance, semantic and feature branches with grids at lr*20 and weight
decay on the density grids, and the instance one (betas 0.9/0.999) over the
instance branch, which leaves the slow net to the EMA in DINO-style
training. The JAX package writes both as optax ``multi_transform`` chains
over one parameter tree; this module writes the same update on tensors:

    mu <- b1 mu + (1-b1) g;  nu <- b2 nu + (1-b2) g^2;  count <- count + 1
    u  = mu / (1 - b1^count) / (sqrt(nu / (1 - b2^count)) + 1e-8)
    u  = u + weight_decay * p          (density grids only: decoupled decay)
    p <- p - lr * lr_scale * u

A group outside a chain (optax's ``set_to_zero``) gets no update and keeps
no state. ``torch.optim.Adam`` does not fit: its weight decay is coupled L2,
it has no per-step ``lr_scale``, and it would keep state for the frozen slow
net.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..utils.observability import span
from ..utils.tree import tree_leaves_with_path, tree_map

# partition labels
MAIN_GRID_WD = "main_grid_wd"   # density grids: lr*20 + weight decay
MAIN_GRID = "main_grid"          # appearance/semantic/feature grids: lr*20
MAIN_NET = "main_net"            # basis mats + appearance/semantic/feature MLPs
INST_GRID = "inst_grid"          # instance grids: lr*20
INST_NET = "inst_net"            # instance basis + fast MLP + fast proj
INST_SLOW = "inst_slow"          # slow MLP + slow proj (optimizer-trained unless DINO)
FROZEN = "frozen"

_MAIN_GRID_BRANCHES = ("appearance", "semantic", "feature")
_MAIN_NET_KEYS = ("appearance_basis", "appearance_mlp", "semantic_basis",
                  "semantic_mlp", "feature_basis", "feature_mlp")


def build_labels(params: dict, use_dino_style: bool) -> dict:
    """{leaf path: label} for every leaf of ``params``."""
    slow = FROZEN if use_dino_style else INST_SLOW
    labels = {}
    for path, _ in tree_leaves_with_path(params):
        key = path[0]
        if key == "density":
            label = MAIN_GRID_WD
        elif key in _MAIN_GRID_BRANCHES:
            label = MAIN_GRID
        elif key in _MAIN_NET_KEYS:
            label = MAIN_NET
        elif key == "instance":
            label = INST_GRID
        elif key == "instance_basis":
            label = INST_NET
        elif key in ("instance_mlp", "proj"):
            label = INST_NET if path[1] == "fast" else slow
        else:
            raise KeyError(f"Unlabelled param branch {key!r}")
        labels[path] = label
    return labels


class AdamSpec(NamedTuple):
    lr: float
    b1: float
    b2: float
    weight_decay: float = 0.0


class AdamState(NamedTuple):
    """One group's state: the step count and the two moments of its leaves,
    keyed by leaf path."""
    count: torch.Tensor                 # [] int32
    mu: Dict[tuple, torch.Tensor]
    nu: Dict[tuple, torch.Tensor]


class AdamChain:
    """One optimizer chain: an Adam group per label in ``groups``; leaves of
    every other label get no update (``set_to_zero``)."""

    def __init__(self, groups: Dict[str, AdamSpec], labels: dict):
        self.groups = groups
        self.labels = labels

    def paths(self, label: str):
        """Leaf paths of a group, in JAX flatten order."""
        return [p for p, lab in self.labels.items() if lab == label]

    def trained_paths(self):
        return [p for p, lab in self.labels.items() if lab in self.groups]

    def init(self, params: dict) -> Dict[str, AdamState]:
        leaves = dict(tree_leaves_with_path(params))
        dev = next(iter(leaves.values())).device
        return {label: AdamState(
            torch.zeros((), dtype=torch.int32, device=dev),
            {p: torch.zeros_like(leaves[p]) for p in self.paths(label)},
            {p: torch.zeros_like(leaves[p]) for p in self.paths(label)})
            for label in self.groups}

    def update(self, grads: dict, state: Dict[str, AdamState], params: dict):
        """(updates {path: tensor} for the trained leaves, new state), as
        optax's ``update``: the parameter step is ``p + u * lr_scale``.
        ``grads`` and ``params`` map leaf paths to tensors."""
        updates, new_state = {}, {}
        with torch.no_grad(), span("adam_update"):
            for label, spec in self.groups.items():
                st = state[label]
                count = st.count + 1
                c = count.to(torch.float32)
                bc1 = 1.0 - torch.pow(torch.tensor(spec.b1, device=c.device), c)
                bc2 = 1.0 - torch.pow(torch.tensor(spec.b2, device=c.device), c)
                mu, nu = {}, {}
                for p in self.paths(label):
                    g = grads[p]
                    mu[p] = (1 - spec.b1) * g + spec.b1 * st.mu[p]
                    nu[p] = (1 - spec.b2) * (g * g) + spec.b2 * st.nu[p]
                    u = (mu[p] / bc1) / (torch.sqrt(nu[p] / bc2) + 1e-8)
                    if spec.weight_decay:
                        u = u + spec.weight_decay * params[p]
                    updates[p] = u * (-spec.lr)
                new_state[label] = AdamState(count, mu, nu)
        return updates, new_state


def make_optimizers(cfg, params: dict):
    """(main chain, instance chain, labels) with the reference's groups:
    grids at lr*20, nets at lr, weight decay on the density grids."""
    labels = build_labels(params, cfg.use_DINO_style)
    main = AdamChain({
        MAIN_GRID_WD: AdamSpec(cfg.lr * 20, 0.9, 0.99, cfg.weight_decay),
        MAIN_GRID: AdamSpec(cfg.lr * 20, 0.9, 0.99),
        MAIN_NET: AdamSpec(cfg.lr, 0.9, 0.99)}, labels)
    inst = AdamChain({
        INST_GRID: AdamSpec(cfg.lr * 20, 0.9, 0.999),
        INST_NET: AdamSpec(cfg.lr, 0.9, 0.999),
        INST_SLOW: AdamSpec(cfg.lr, 0.9, 0.999)}, labels)
    return main, inst, labels


class TrainState(NamedTuple):
    params: dict
    opt_state_main: Dict[str, AdamState]
    opt_state_inst: Dict[str, AdamState]
    step: torch.Tensor


def init_train_state(cfg, params: dict) -> TrainState:
    main, inst, _ = make_optimizers(cfg, params)
    dev = tree_leaves_with_path(params)[0][1].device
    return TrainState(params, main.init(params), inst.init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def ema_update_slow(params: dict, momentum: float = 0.9,
                    use_proj: bool = False) -> dict:
    """slow <- momentum * slow + (1 - momentum) * fast for the instance MLP
    (and the projection heads with ``use_proj``), without gradient."""
    def ema(slow_tree, fast_tree):
        return tree_map(lambda s, f: momentum * s + (1 - momentum) * f.detach(),
                        slow_tree, fast_tree)

    out = dict(params)
    imlp = dict(params["instance_mlp"])
    imlp["slow"] = ema(imlp["slow"], imlp["fast"])
    out["instance_mlp"] = imlp
    if use_proj and "proj" in params:
        proj = dict(params["proj"])
        proj["slow"] = ema(proj["slow"], proj["fast"])
        out["proj"] = proj
    return out
