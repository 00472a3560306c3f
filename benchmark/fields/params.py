"""The TensoRF parameter tree of a configuration, drawn on the device.

The tree has the layout the port reads (``models/tensorf.py``): VM factor
grids ``{"planes": (3 x [C, g_m1, g_m0]), "lines": (3 x [C, g_v])}`` for
density and appearance, the appearance basis ``{"w": [sum C, 27]}`` and the
MLPs ``{"layers": [{"w": [in, out], "b": [out]}, ...]}``. Every leaf is a
slice of one normal and one uniform draw made by a ``torch.Generator`` on
the device, so a run's weights cost two kernel launches, whatever the size.
The distributions are the port's init (factors 0.1 N(0, 1), linear layers
U(-1/sqrt(in), 1/sqrt(in)), last appearance bias 0); the draws are not.
"""
from __future__ import annotations

import math

import torch

MATRIX_MODE = ((0, 1), (0, 2), (1, 2))
# the VM factor grids of the tree (the main chain's grid group, trained at
# 20 times the rate of the MLPs and the basis); the plain reference, which
# imports nothing of the harness, names them itself (``MAIN_GRID``)
GRID_GROUPS = ("density", "appearance")
VECTOR_MODE = (2, 1, 0)


def _pe_width(dim: int, freqs: int) -> int:
    return 2 * freqs * dim


def mlp_shapes(model: dict, num_classes: int) -> dict:
    """{head: [(in, out), ...]} of every MLP of the configuration."""
    w = model["mlp_width"]
    app_in = (model["dim_appearance"] + 3
              + _pe_width(model["dim_appearance"], model["pe_feat"])
              + _pe_width(3, model["pe_view"]))
    c = model["dim_mlp_color"]
    heads = {"appearance_mlp": [(app_in, c), (c, c), (c, 3)]}
    n = model["semantic_layers"]
    heads["semantic_mlp"] = ([(3, w)] + [(w, w)] * (n - 2)
                             + [(w, num_classes)])
    n = model["instance_layers"]
    for name in model["instance_heads"]:
        heads[f"instance_mlp.{name}"] = ([(3, w)] + [(w, w)] * (n - 2)
                                         + [(w, model["instance_out"])])
    return heads


def factor_shapes(comps, grid_dim):
    planes = [(comps[i], grid_dim[MATRIX_MODE[i][1]],
               grid_dim[MATRIX_MODE[i][0]]) for i in range(3)]
    lines = [(comps[i], grid_dim[VECTOR_MODE[i]]) for i in range(3)]
    return planes, lines


def make_params(spec: dict, seed: int, device, grid_dim=None) -> dict:
    """The parameter tree of configuration ``spec`` (a ``configs/*.json``)
    at ``grid_dim`` (default: the configuration's), drawn from ``seed``."""
    model = spec["model"]
    grid_dim = tuple(grid_dim or spec["grid_dim"])
    d_planes, d_lines = factor_shapes(model["num_density_comps"], grid_dim)
    a_planes, a_lines = factor_shapes(model["num_appearance_comps"], grid_dim)
    normal = d_planes + d_lines + a_planes + a_lines
    heads = mlp_shapes(model, spec["num_semantic_classes"])
    basis = (sum(model["num_appearance_comps"]), model["dim_appearance"])
    uniform = [basis] + [s for layers in heads.values()
                         for (i, o) in layers for s in ((i, o), (o,))]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n_normal = sum(math.prod(s) for s in normal)
    n_uniform = sum(math.prod(s) for s in uniform)
    flat_n = torch.randn(n_normal, generator=gen, device=device) * 0.1
    flat_u = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0

    def take(flat, offset, shape):
        n = math.prod(shape)
        return flat[offset:offset + n].view(shape), offset + n

    off = 0
    leaves = []
    for s in normal:
        t, off = take(flat_n, off, s)
        leaves.append(t)
    params = {
        "density": {"planes": tuple(leaves[0:3]), "lines": tuple(leaves[3:6])},
        "appearance": {"planes": tuple(leaves[6:9]),
                       "lines": tuple(leaves[9:12])},
    }
    off = 0
    t, off = take(flat_u, off, basis)
    params["appearance_basis"] = {"w": t / math.sqrt(basis[0])}
    for head, layers in heads.items():
        out = []
        for li, (i, o) in enumerate(layers):
            bound = 1.0 / math.sqrt(i)
            w, off = take(flat_u, off, (i, o))
            b, off = take(flat_u, off, (o,))
            b = b * bound
            if head == "appearance_mlp" and li == len(layers) - 1:
                b = torch.zeros_like(b)
            out.append({"w": w * bound, "b": b})
        if head.startswith("instance_mlp."):
            params.setdefault("instance_mlp", {})[head.split(".", 1)[1]] = {
                "layers": out}
        else:
            params[head] = {"layers": out}
    return params

