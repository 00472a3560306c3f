"""Reference-checkpoint ingestion: torch Lightning .ckpt -> the npz format.

Port of ``contrastive_lift_tpu/io/torch_import.py``. The reference publishes
pretrained checkpoints: Lightning dicts whose state_dict holds ``model.*``
parameters and ``renderer.*`` buffers. This converter maps them into the
parameter tree and writes the npz layout of ``io/checkpoint.py``, which
both packages' ``load_checkpoint`` read; on the same state dict it writes
the arrays the JAX converter writes.

Key layout translations:
  torch Linear weight [out, in]          -> w [in, out] (transposed)
  plane [1, C, H, W] / line [1, C, L, 1] -> [C, H, W] / [C, L]
  Sequential indices mlp.{0,2,4,...}     -> layers[0..n-1]
  weight-normed DINO last layer          -> last_v = weight_v.T (unit gain)
  renderer.grid_dim / renderer.bbox_aabb -> checkpoint metadata

Usage:
    python -m contrastive_lift_tpu_torch.io.torch_import --ckpt_path REF.ckpt --output_path OURS.npz
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..utils.tree import tree_leaves_with_path
from .checkpoint import save_checkpoint


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), np.float32)


def _import_linear(sd: dict, prefix: str) -> dict:
    out = {"w": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["b"] = _np(sd[f"{prefix}.bias"])
    return out


def _import_mlp(sd: dict, prefix: str) -> dict:
    """Sequential of Linear/ReLU: linears live at even indices 0,2,4,..."""
    layers = []
    i = 0
    while f"{prefix}.{i}.weight" in sd:
        layers.append(_import_linear(sd, f"{prefix}.{i}"))
        i += 2
    if not layers:
        raise KeyError(f"no linear layers under {prefix}")
    return {"layers": layers}


def _import_grid(sd: dict, plane_key: str, line_key: str) -> dict:
    planes, lines = [], []
    for i in range(3):
        planes.append(_np(sd[f"{plane_key}.{i}"])[0])        # [C, H, W]
        lines.append(_np(sd[f"{line_key}.{i}"])[0, :, :, 0])  # [C, L]
    return {"planes": tuple(planes), "lines": tuple(lines)}


def _import_dino_head(sd: dict, prefix: str) -> dict:
    mlp = {"w": _np(sd[f"{prefix}.mlp.weight"]).T,
           "b": _np(sd[f"{prefix}.mlp.bias"])}
    # weight_norm(last_layer): w = g * v/||v||; checkpoints fix g = 1
    v_key = (f"{prefix}.last_layer.weight_v"
             if f"{prefix}.last_layer.weight_v" in sd
             else f"{prefix}.last_layer.parametrizations.weight.original1")
    return {"mlp": mlp, "last_v": _np(sd[v_key]).T}


def convert_state_dict(state_dict: dict) -> tuple[dict, dict]:
    """(params, renderer_meta) from a reference Lightning state_dict."""
    sd = dict(state_dict)
    m = "model."
    params: dict = {}
    params["density"] = _import_grid(sd, f"{m}density_plane", f"{m}density_line")
    params["appearance"] = _import_grid(sd, f"{m}appearance_plane",
                                        f"{m}appearance_line")
    params["appearance_basis"] = _import_linear(sd, f"{m}appearance_basis_mat")
    params["appearance_mlp"] = _import_mlp(sd, f"{m}render_appearance_mlp.mlp")

    if f"{m}semantic_plane.0" in sd:
        params["semantic"] = _import_grid(sd, f"{m}semantic_plane",
                                          f"{m}semantic_line")
        params["semantic_basis"] = _import_linear(sd, f"{m}semantic_basis_mat")
    if f"{m}render_semantic_mlp.mlp.0.weight" in sd:
        params["semantic_mlp"] = _import_mlp(sd, f"{m}render_semantic_mlp.mlp")
    elif f"{m}render_semantic_mlp.mlp_backbone.0.weight" in sd:
        # feature-regularization variant: backbone + class head become one MLP
        backbone = _import_mlp(sd, f"{m}render_semantic_mlp.mlp_backbone")
        head = _import_linear(sd, f"{m}render_semantic_mlp.head_class")
        params["semantic_mlp"] = {"layers": backbone["layers"] + [head]}

    if f"{m}instance_plane.0" in sd:
        params["instance"] = _import_grid(sd, f"{m}instance_plane",
                                          f"{m}instance_line")
        params["instance_basis"] = _import_linear(sd, f"{m}instance_basis_mat")
    if f"{m}render_instance_mlp.mlp.0.weight" in sd:
        params["instance_mlp"] = {
            "fast": _import_mlp(sd, f"{m}render_instance_mlp.mlp")}
        if f"{m}render_instance_mlp.slow_mlp.0.weight" in sd:
            params["instance_mlp"]["slow"] = _import_mlp(
                sd, f"{m}render_instance_mlp.slow_mlp")

    if f"{m}feature_plane.0" in sd:
        params["feature"] = _import_grid(sd, f"{m}feature_plane", f"{m}feature_line")
        params["feature_basis"] = _import_linear(sd, f"{m}feature_basis_mat")
        params["feature_mlp"] = _import_mlp(sd, f"{m}render_feature_mlp.mlp")

    if f"{m}proj_layer.fast_proj.mlp.weight" in sd:
        params["proj"] = {
            "fast": _import_dino_head(sd, f"{m}proj_layer.fast_proj"),
            "slow": _import_dino_head(sd, f"{m}proj_layer.slow_proj")}

    renderer_meta = {}
    if "renderer.bbox_aabb" in sd:
        renderer_meta["bbox_aabb"] = _np(sd["renderer.bbox_aabb"]).tolist()
    if "renderer.grid_dim" in sd:
        renderer_meta["grid_dim"] = [int(x) for x in
                                     np.asarray(sd["renderer.grid_dim"].cpu())]
    return params, renderer_meta


def convert_torch_checkpoint(ckpt_path, output_path,
                             config_dict: Optional[dict] = None) -> dict:
    """Load a Lightning .ckpt (a torch pickle: give it only files from a
    source you trust) and write the npz checkpoint."""
    # a Lightning dict holds more than tensors: torch.load refuses it with
    # its default weights_only=True
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    params, meta = convert_state_dict(state_dict)
    grid_dim = meta.get("grid_dim")
    if grid_dim is None:
        planes = params["density"]["planes"]
        grid_dim = [planes[0].shape[2], planes[0].shape[1],
                    params["density"]["lines"][0].shape[1]]
    bbox = meta.get("bbox_aabb", [[-1, -1, -1], [1, 1, 1]])
    save_checkpoint(Path(output_path), params, grid_dim=grid_dim,
                    bbox_aabb=np.asarray(bbox, np.float32),
                    epoch=int(ckpt.get("epoch", 0)),
                    global_step=int(ckpt.get("global_step", 0)),
                    config_dict=config_dict,
                    extra={"source": str(ckpt_path), "imported_from": "torch"})
    return {"grid_dim": grid_dim, "bbox_aabb": bbox,
            "num_params": sum(int(np.prod(np.shape(x)))
                              for _, x in tree_leaves_with_path(params))}


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="Convert a reference torch .ckpt to an npz checkpoint")
    parser.add_argument("--ckpt_path", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    info = convert_torch_checkpoint(args.ckpt_path, args.output_path)
    print(info)
    return info


if __name__ == "__main__":
    main()
