"""Carry weights across: the JAX package's parameter tree -> the port's tensors."""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """The parameter tree of ``load_checkpoint`` (dicts, lists and tuples of
    numpy arrays) with every leaf a torch tensor on ``device``, same dtype,
    structure unchanged (``planes``/``lines`` stay tuples)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)
