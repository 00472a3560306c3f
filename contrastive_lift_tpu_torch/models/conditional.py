"""Latent-conditioned TensoRF: the density through a latent-aware MLP.

Port of ``contrastive_lift_tpu/models/conditional.py`` (the reference's
``ConditionalTensorVMSplit``, which the paper's main path does not use).
Every branch is conditioned on a per-scene or per-object latent code: the
density is softplus(MLP([density features, latent]) + shift) in place of the
plain softplus of the summed factors, and the appearance MLP takes the latent
after its other inputs. Parameters are ``init_tensorf``'s tree plus
``density_basis``, ``density_mlp`` (its last layer without a bias) and a
wider ``appearance_mlp``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.grid_sample import vm_feature
from . import tensorf as tf


@dataclass(frozen=True)
class ConditionalConfig:
    base: tf.TensoRFConfig
    latent_dim: int = 16
    dim_density: int = 12
    dim_mlp_density: int = 32


def init_conditional(gen: torch.Generator, ccfg: ConditionalConfig, grid_dim,
                     device="cuda") -> dict:
    """``init_tensorf``'s parameters plus the density basis and MLP, and the
    appearance MLP drawn again with ``latent_dim`` more input channels, all
    from ``gen`` (a CPU ``torch.Generator``; the draws are not JAX's), on
    ``device``."""
    from ..utils.device import resolve_device
    from ..utils.tree import tree_map
    device = resolve_device(device)
    params = tf.init_tensorf(gen, ccfg.base, grid_dim, device="cpu")
    base = ccfg.base
    params["density_basis"] = tf._linear_init(
        gen, sum(base.num_density_comps), ccfg.dim_density, bias=False)
    # density MLP: in = feat + latent; the last layer has no bias
    mlp = tf._mlp_init(gen, ccfg.dim_density + ccfg.latent_dim,
                       ccfg.dim_mlp_density, 1, 3)
    mlp["layers"][-1].pop("b")
    params["density_mlp"] = mlp
    in_app = (base.dim_appearance + 3 + 2 * base.pe_feat * base.dim_appearance
              + 2 * base.pe_view * 3 + ccfg.latent_dim)
    params["appearance_mlp"] = tf._mlp_init(gen, in_app, base.dim_mlp_color,
                                            3, 3, zero_last_bias=True)
    return tree_map(lambda t: t.to(device), params)


def _mlp_no_last_bias(params_mlp, x: torch.Tensor) -> torch.Tensor:
    """Linear layers with ReLU between; a layer without ``b`` adds none."""
    layers = params_mlp["layers"]
    h = x
    for i, layer in enumerate(layers):
        h = h @ layer["w"]
        if "b" in layer:
            h = h + layer["b"]
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def compute_density_conditional(params, ccfg: ConditionalConfig,
                                xyz: torch.Tensor,
                                latents: torch.Tensor) -> torch.Tensor:
    """softplus(MLP([density features, latent]) + shift) at [P, 3]
    normalized points with [P, latent_dim] latents."""
    d = params["density"]
    feat = vm_feature(d["planes"], d["lines"], xyz) @ params["density_basis"]["w"]
    raw = _mlp_no_last_bias(params["density_mlp"],
                            torch.cat([feat, latents], dim=-1))[..., 0]
    return tf._softplus(raw + ccfg.base.splus_density_shift)


def render_appearance_conditional(params, ccfg: ConditionalConfig, viewdirs,
                                  xyz, latents) -> torch.Tensor:
    """sigmoid(MLP([feat, viewdirs, PE(feat), PE(viewdirs), latent]))."""
    base = ccfg.base
    feats = tf._branch_feature(params, "appearance", xyz)
    indata = [feats, viewdirs]
    if base.pe_feat > 0:
        indata.append(tf.positional_encoding(feats, base.pe_feat))
    if base.pe_view > 0:
        indata.append(tf.positional_encoding(viewdirs, base.pe_view))
    indata.append(latents)
    return torch.sigmoid(tf.mlp_apply(params["appearance_mlp"],
                                      torch.cat(indata, -1)))
