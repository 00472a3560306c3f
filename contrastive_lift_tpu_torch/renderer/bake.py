"""Baked inference heads: the position-only head MLPs evaluated once at the voxel nodes.

Port of ``contrastive_lift_tpu/renderer/bake.py``. At inference the semantic
and instance heads are functions of position alone (of xyz, or of grid
features at xyz); only the appearance head sees the view direction. Baking
runs those two heads once per scene on the g^3 voxel nodes and keeps their
outputs, the semantic logits then the instance features, in bfloat16; the
render then reads a sample's outputs by the trilinear interpolation of its
cell's 8 nodes in place of running the MLPs
(``renderer/render.py::_semins_block``). The maps become interpolations of
node-exact head outputs instead of head outputs of interpolated inputs: an
approximation the JAX package bounds on a trained field
(``tests/test_bake_heads.py``), and ``tests/test_torch_port_options.py``
bounds the port's the same way.

The JAX package stores the baked outputs as corner rows of its compacted
cell table; the port keeps them as a dense [g^3, C + D] grid,
``FusedGrids.features["baked"]``, read under the slot map like every other
feature grid, which gives the same values (a sample in a block without a
slot reads zero). As in the JAX package, baking needs the compacted build
(``build_render_grids(compact=True)``, whose slot map it reads through). The
node MLPs are plain matrix products, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import torch

from ..models import tensorf as tf
from ..ops.fused_grid import FusedGrids, build_dense_feature


def baked_width(mcfg) -> int:
    """Columns of the baked payload: [semantic logits, instance features]."""
    return mcfg.num_semantic_classes + mcfg.dim_feature_instance


def _node_head_outputs(params, mcfg, xyz, grid_feats, compute_dtype):
    """Head outputs at [P, 3] normalized node coords: the semantic logits
    (before the softmax) and the instance features ([fast, slow] in
    slow-fast mode). ``grid_feats``: the branch features of grid heads, and
    of the distilled ``feature`` branch, at the same nodes. The distilled
    head runs here in ``compute_dtype`` (the render's ``render_distilled``
    runs its MLP in float32), as in the JAX package. Port of
    ``_node_head_outputs``."""
    distilled = None
    if mcfg.use_distilled:
        distilled = torch.tanh(tf.mlp_apply(params["feature_mlp"],
                                            grid_feats["feature"],
                                            compute_dtype))
    if mcfg.use_semantic_mlp:
        sem_feat, sem_pe = xyz, mcfg.pe_sem
    else:
        sem_feat, sem_pe = grid_feats["semantic"], 0
    d = distilled if mcfg.use_distilled_features_semantic else None
    sem = tf.mlp_apply(params["semantic_mlp"],
                       tf._head_input(mcfg, sem_pe, sem_feat, d),
                       compute_dtype)
    if mcfg.use_instance_mlp:
        ins_feat, ins_pe = xyz, mcfg.pe_ins
    else:
        ins_feat, ins_pe = grid_feats["instance"], 0
    d_i = distilled if mcfg.use_distilled_features_instance else None
    ins_in = tf._head_input(mcfg, ins_pe, ins_feat, d_i)
    ins = tf.mlp_apply(params["instance_mlp"]["fast"], ins_in, compute_dtype)
    if mcfg.slow_fast_mode:
        slow = tf.mlp_apply(params["instance_mlp"]["slow"], ins_in,
                            compute_dtype)
        ins = torch.cat([ins, slow], dim=-1)
    return torch.cat([sem, ins], dim=-1)


def bake_head_tables(params, mcfg, fused: FusedGrids,
                     compute_dtype=torch.bfloat16,
                     chunk: int = 1 << 17) -> FusedGrids:
    """``fused`` with the baked semantic + instance table (bfloat16
    [g^3, ``baked_width``], ``features["baked"]``), the heads run on
    ``chunk`` nodes at a time in ``compute_dtype``, on the grids' device.
    Needs the compacted build (its slot map). Port of ``bake_head_tables``."""
    if fused.slot_map is None:
        raise ValueError("bake_head_tables needs the compacted grids "
                         "(build_render_grids(compact=True))")
    gx, gy, gz = (int(g) for g in fused.grid_dim)
    n = gx * gy * gz
    dev = fused.slot_map.device
    g1 = torch.tensor((gx - 1, gy - 1, gz - 1), dtype=torch.float32,
                      device=dev)
    grids = {name: build_dense_feature(params, name)
             for name in ("semantic", "instance", "feature")
             if name in params}
    table = torch.empty((n, baked_width(mcfg)), dtype=torch.bfloat16,
                        device=dev)
    with torch.no_grad():
        for start in range(0, n, chunk):
            idx = torch.arange(start, min(n, start + chunk), device=dev)
            node = torch.stack([idx // (gy * gz), (idx // gz) % gy, idx % gz],
                               dim=-1)
            xyz = node.to(torch.float32) / g1 * 2.0 - 1.0
            feats = {k: v[start:start + len(idx)] for k, v in grids.items()}
            table[start:start + len(idx)] = _node_head_outputs(
                params, mcfg, xyz, feats, compute_dtype).to(torch.bfloat16)
    return fused._replace(features={**fused.features, "baked": table})
