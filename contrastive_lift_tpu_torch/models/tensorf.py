"""TensoRF panoptic field: config, initialization, density and MLP heads.

Port of ``contrastive_lift_tpu/models/tensorf.py``. Parameters are the JAX
package's tree with torch tensors at the leaves
(``io/convert.py::params_from_numpy``); linear layers keep the JAX layout
``x @ w + b`` with ``w`` as [in, out]. Grid-branch features come from the
dense grids of ``ops/fused_grid.py`` (``feats=``) or, without them, from the
VM factors sampled directly (``ops/grid_sample.py``). The grid lifecycle
(``upsample_volume_grid``, ``shrink_volume_grid``) resizes the factors
between training stages. The distilled-feature head (``render_distilled``:
the 96-d projected ``feature`` branch through ``feature_mlp`` and a tanh)
feeds its 64-d output to the semantic and instance heads as their last
input columns, after the positional encoding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.grid_sample import (MATRIX_MODE, VECTOR_MODE, upsample_line,
                                upsample_plane, vm_density, vm_feature)
from ..utils.tree import tree_map


@dataclass(frozen=True)
class TensoRFConfig:
    num_semantic_classes: int
    dim_feature_instance: int
    num_density_comps: Tuple[int, int, int] = (16, 16, 16)
    num_appearance_comps: Tuple[int, int, int] = (48, 48, 48)
    num_semantics_comps: Optional[Tuple[int, int, int]] = (32, 32, 32)
    num_instance_comps: Optional[Tuple[int, int, int]] = (32, 32, 32)
    num_feature_comps: Tuple[int, int, int] = (48, 48, 48)
    dim_appearance: int = 27
    dim_semantics: int = 27
    dim_instances: int = 27
    splus_density_shift: float = -10.0
    pe_view: int = 2
    pe_feat: int = 2
    pe_sem: int = 0
    pe_ins: int = 0
    dim_mlp_color: int = 128
    dim_mlp_semantics: int = 128
    dim_mlp_instance: int = 256
    semantic_output_softmax: bool = True  # Softmax head iff semantic_weight_mode=="softmax"
    use_semantic_mlp: bool = True
    use_instance_mlp: bool = True
    use_distilled_features_semantic: bool = False
    use_distilled_features_instance: bool = False
    slow_fast_mode: bool = False
    use_proj: bool = False

    @property
    def use_distilled(self) -> bool:
        return self.use_distilled_features_semantic or self.use_distilled_features_instance

    @property
    def instance_out_channels(self) -> int:
        # each of fast/slow outputs half the rendered embedding in slow_fast mode
        return self.dim_feature_instance // 2 if self.slow_fast_mode else self.dim_feature_instance


def positional_encoding(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """[..., D] -> [..., 2*freqs*D]; per-dim frequencies vary fastest."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(*x.shape[:-1], freqs * x.shape[-1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def mlp_apply(params, x: torch.Tensor,
              compute_dtype=torch.float32) -> torch.Tensor:
    """The head MLP: Linear layers with ReLU between, output in float32.
    (The JAX package wraps it in activation checkpointing; the port's
    training step checkpoints whole segment chunks instead.)"""
    layers = params["layers"]
    h = x.to(compute_dtype)
    for i, layer in enumerate(layers):
        h = h @ layer["w"].to(compute_dtype) + layer["b"].to(compute_dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h.to(torch.float32)


# ---------------------------------------------------------------------------
# Initializers (torch-parity distributions; draws from a torch.Generator)
# ---------------------------------------------------------------------------

def _uniform(gen, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def _linear_init(gen, din: int, dout: int, bias: bool = True,
                 zero_bias: bool = False) -> dict:
    """torch.nn.Linear default init: U(-1/sqrt(din), 1/sqrt(din))."""
    bound = 1.0 / np.sqrt(din)
    params = {"w": _uniform(gen, (din, dout), bound)}
    if bias:
        b = _uniform(gen, (dout,), bound)
        params["b"] = torch.zeros(dout) if zero_bias else b
    return params


def _mlp_init(gen, din: int, dim: int, dout: int, n_layers: int,
              zero_last_bias: bool = False) -> dict:
    """n_layers Linears with ReLU between; mirrors the reference heads."""
    layers = [_linear_init(gen, din, dim if n_layers > 1 else dout)]
    for _ in range(1, n_layers - 1):
        layers.append(_linear_init(gen, dim, dim))
    if n_layers > 1:
        layers.append(_linear_init(gen, dim, dout, zero_bias=zero_last_bias))
    return {"layers": layers}


def _svd_grid_init(gen, comps, grid_dim, scale: float = 0.1) -> dict:
    """Per-axis plane [C, g_m1, g_m0] and line [C, g_v] factors ~
    scale * N(0, 1)."""
    planes, lines = [], []
    for i in range(3):
        m0, m1 = MATRIX_MODE[i]
        v = VECTOR_MODE[i]
        planes.append(scale * torch.randn(
            (comps[i], grid_dim[m1], grid_dim[m0]), generator=gen))
        lines.append(scale * torch.randn((comps[i], grid_dim[v]),
                                         generator=gen))
    return {"planes": tuple(planes), "lines": tuple(lines)}


def _trunc_normal(gen, shape, std: float = 0.02) -> torch.Tensor:
    """std * N(0, 1) truncated to [-2, 2], as ``jax.random.truncated_normal``."""
    out = torch.empty(shape)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return std * out


def _dino_head_init(gen, din: int, dout: int, bottleneck: int = 8) -> dict:
    """DINOHead with nlayers=1: Linear(din, bottleneck) -> l2norm ->
    weight-normed Linear(bottleneck, dout, no bias) with unit gain."""
    mlp = {"w": _trunc_normal(gen, (din, bottleneck)),
           "b": torch.zeros(bottleneck)}
    return {"mlp": mlp,
            "last_v": _linear_init(gen, bottleneck, dout, bias=False)["w"]}


def init_tensorf(gen: torch.Generator, cfg: TensoRFConfig, grid_dim,
                 device="cuda") -> dict:
    """The full parameter tree at a given grid resolution, drawn from
    ``gen`` (a CPU ``torch.Generator``) with the JAX package's distributions
    and shapes, then moved to ``device``. The draws are not JAX's."""
    from ..utils.device import resolve_device
    device = resolve_device(device)
    grid_dim = tuple(int(g) for g in grid_dim)
    params = {}
    params["density"] = _svd_grid_init(gen, cfg.num_density_comps, grid_dim)
    params["appearance"] = _svd_grid_init(gen, cfg.num_appearance_comps,
                                          grid_dim)
    params["appearance_basis"] = _linear_init(
        gen, sum(cfg.num_appearance_comps), cfg.dim_appearance, bias=False)
    # appearance MLP: in = feat + viewdir + PE(feat) + PE(viewdir)
    in_app = (cfg.dim_appearance + 3 + 2 * cfg.pe_feat * cfg.dim_appearance
              + 2 * cfg.pe_view * 3)
    params["appearance_mlp"] = _mlp_init(gen, in_app, cfg.dim_mlp_color, 3, 3,
                                         zero_last_bias=True)

    extra = 64 if cfg.use_distilled_features_semantic else 0
    if cfg.use_semantic_mlp:
        params["semantic_mlp"] = _mlp_init(gen, 3 + 2 * cfg.pe_sem * 3 + extra,
                                           256, cfg.num_semantic_classes, 5)
    elif cfg.num_semantics_comps is not None:
        params["semantic"] = _svd_grid_init(gen, cfg.num_semantics_comps,
                                            grid_dim)
        params["semantic_basis"] = _linear_init(
            gen, sum(cfg.num_semantics_comps), cfg.dim_semantics, bias=False)
        params["semantic_mlp"] = _mlp_init(
            gen, cfg.dim_semantics + extra, cfg.dim_mlp_semantics,
            cfg.num_semantic_classes, 3)

    extra_i = 64 if cfg.use_distilled_features_instance else 0
    ins_out = cfg.instance_out_channels
    names = ("fast", "slow") if cfg.slow_fast_mode else ("fast",)
    if cfg.use_instance_mlp:
        in_ins = 3 + 2 * cfg.pe_ins * 3 + extra_i
        params["instance_mlp"] = {n: _mlp_init(gen, in_ins, cfg.dim_mlp_instance,
                                               ins_out, 4) for n in names}
    elif cfg.num_instance_comps is not None:
        params["instance"] = _svd_grid_init(gen, cfg.num_instance_comps,
                                            grid_dim)
        params["instance_basis"] = _linear_init(
            gen, sum(cfg.num_instance_comps), cfg.dim_instances, bias=False)
        params["instance_mlp"] = {
            n: _mlp_init(gen, cfg.dim_instances + extra_i,
                         cfg.dim_mlp_instance, ins_out, 3) for n in names}

    if cfg.use_distilled:
        params["feature"] = _svd_grid_init(gen, cfg.num_feature_comps,
                                           grid_dim)
        params["feature_basis"] = _linear_init(
            gen, sum(cfg.num_feature_comps), 96, bias=False)
        params["feature_mlp"] = _mlp_init(gen, 96, 256, 64, 3)

    if cfg.use_proj:
        params["proj"] = {"fast": _dino_head_init(gen, ins_out, 32),
                          "slow": _dino_head_init(gen, ins_out, 32)}
    return tree_map(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# Field evaluation (flat [P, ...] points, xyz normalized to [-1, 1])
# ---------------------------------------------------------------------------

def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x), as jax.nn.softplus: F.softplus is the identity above 20
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def compute_density_raw(params, cfg: TensoRFConfig,
                        xyz: torch.Tensor) -> torch.Tensor:
    """Pre-activation density plus the shift, sampled from the VM factors."""
    d = params["density"]
    return vm_density(d["planes"], d["lines"], xyz) + cfg.splus_density_shift


def compute_density(params, cfg: TensoRFConfig,
                    xyz: torch.Tensor) -> torch.Tensor:
    return _softplus(compute_density_raw(params, cfg, xyz))


def _branch_feature(params, name: str, xyz: torch.Tensor) -> torch.Tensor:
    """Projected features of a VM branch, sampled from its factors."""
    g = params[name]
    return vm_feature(g["planes"], g["lines"], xyz) @ params[f"{name}_basis"]["w"]


def dino_head_apply(params, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["mlp"]["w"] + params["mlp"]["b"]
    h = h / (torch.linalg.norm(h, dim=-1, keepdim=True) + 1e-12)
    v = params["last_v"]
    return h @ (v / (torch.linalg.norm(v, dim=0, keepdim=True) + 1e-12))


def apply_proj(params, fast_x, slow_x):
    """The optional DINO projection heads of the fast and slow embeddings."""
    return (dino_head_apply(params["proj"]["fast"], fast_x),
            dino_head_apply(params["proj"]["slow"], slow_x))


def render_appearance(params, cfg: TensoRFConfig, viewdirs, xyz,
                      compute_dtype=torch.float32, feats=None) -> torch.Tensor:
    """RGB head. Input order: [feat, viewdirs, PE(feat), PE(viewdirs)];
    ``feats`` are the dense-grid features, else the factors are sampled."""
    if feats is None:
        feats = _branch_feature(params, "appearance", xyz)
    indata = [feats, viewdirs]
    if cfg.pe_feat > 0:
        indata.append(positional_encoding(feats, cfg.pe_feat))
    if cfg.pe_view > 0:
        indata.append(positional_encoding(viewdirs, cfg.pe_view))
    out = mlp_apply(params["appearance_mlp"], torch.cat(indata, -1),
                    compute_dtype)
    return torch.sigmoid(out)


def render_distilled(params, cfg: TensoRFConfig, xyz,
                     feats=None) -> torch.Tensor:
    """The 64-d distilled-feature head: tanh(feature_mlp(feats)), the MLP in
    float32; ``feats`` are the 96-d dense-grid features of the ``feature``
    branch, else the factors are sampled."""
    if feats is None:
        feats = _branch_feature(params, "feature", xyz)
    return torch.tanh(mlp_apply(params["feature_mlp"], feats))


def _head_input(cfg, pe, xyz_or_feat, distilled):
    """[input, PE(input), distilled]: the distilled features come last."""
    indata = [xyz_or_feat]
    if pe > 0:
        indata.append(positional_encoding(xyz_or_feat, pe))
    if distilled is not None:
        indata.append(distilled)
    return torch.cat(indata, -1)


def semantic_backbone_feats(params, cfg: TensoRFConfig, xyz) -> torch.Tensor:
    """The semantic MLP's penultimate features (every layer but the last),
    without the distilled input: the hook of the feature-regularization
    variant."""
    feat = xyz if cfg.use_semantic_mlp else _branch_feature(params, "semantic",
                                                            xyz)
    pe = cfg.pe_sem if cfg.use_semantic_mlp else 0
    h = _head_input(cfg, pe, feat, None)
    for layer in params["semantic_mlp"]["layers"][:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    return h


def render_semantics(params, cfg: TensoRFConfig, xyz, distilled=None,
                     compute_dtype=torch.float32, feats=None) -> torch.Tensor:
    """Semantic head over xyz (use_semantic_mlp) or grid features."""
    if cfg.use_semantic_mlp:
        feat, pe = xyz, cfg.pe_sem
    else:
        feat = (feats if feats is not None
                else _branch_feature(params, "semantic", xyz))
        pe = 0
    d = distilled if cfg.use_distilled_features_semantic else None
    out = mlp_apply(params["semantic_mlp"], _head_input(cfg, pe, feat, d),
                    compute_dtype)
    if cfg.semantic_output_softmax:
        out = torch.softmax(out, dim=-1)
    return out


def render_instances(params, cfg: TensoRFConfig, xyz, distilled=None,
                     compute_dtype=torch.float32, feats=None) -> torch.Tensor:
    """Instance head; in slow_fast mode returns [fast, slow] concatenated."""
    if cfg.use_instance_mlp:
        feat, pe = xyz, cfg.pe_ins
    else:
        feat = (feats if feats is not None
                else _branch_feature(params, "instance", xyz))
        pe = 0
    d = distilled if cfg.use_distilled_features_instance else None
    mlp_in = _head_input(cfg, pe, feat, d)
    out = mlp_apply(params["instance_mlp"]["fast"], mlp_in, compute_dtype)
    if cfg.slow_fast_mode:
        slow = mlp_apply(params["instance_mlp"]["slow"], mlp_in, compute_dtype)
        out = torch.cat([out, slow], dim=-1)
    return out


# ---------------------------------------------------------------------------
# Grid lifecycle (between training stages, shape-changing)
# ---------------------------------------------------------------------------

_GRID_BRANCHES = ("density", "appearance", "semantic", "instance", "feature")


def _map_factors(params: dict, plane_fn, line_fn) -> dict:
    """``params`` with every grid branch's plane i replaced by
    ``plane_fn(plane, i)`` and line i by ``line_fn(line, i)``."""
    out = dict(params)
    for name in _GRID_BRANCHES:
        if name in params:
            g = params[name]
            out[name] = {
                "planes": tuple(plane_fn(p, i) for i, p in enumerate(g["planes"])),
                "lines": tuple(line_fn(l, i) for i, l in enumerate(g["lines"]))}
    return out


def upsample_volume_grid(params: dict, res_target) -> dict:
    """All factor grids resized to ``res_target`` (align-corners bilinear
    planes, linear lines). Plane i becomes [C, res[m1], res[m0]]."""
    res = tuple(int(r) for r in res_target)
    with torch.no_grad():
        return _map_factors(
            params,
            lambda p, i: upsample_plane(p, (res[MATRIX_MODE[i][1]],
                                            res[MATRIX_MODE[i][0]])),
            lambda l, i: upsample_line(l, res[VECTOR_MODE[i]]))


def shrink_volume_grid(params: dict, t_l, b_r) -> dict:
    """All factor grids cropped to the voxel range [t_l, b_r) per axis."""
    t_l = [int(x) for x in t_l]
    b_r = [int(x) for x in b_r]

    def plane(p, i):
        m0, m1 = MATRIX_MODE[i]
        return p[:, t_l[m1]:b_r[m1], t_l[m0]:b_r[m0]].contiguous()

    def line(l, i):
        v = VECTOR_MODE[i]
        return l[:, t_l[v]:b_r[v]].contiguous()

    return _map_factors(params, plane, line)


def grid_dim_of(params: dict) -> Tuple[int, int, int]:
    """(gx, gy, gz) from the density factors: plane 0 is [C, g1, g0], line 0
    is [C, g2]."""
    planes = params["density"]["planes"]
    return (int(planes[0].shape[2]), int(planes[0].shape[1]),
            int(params["density"]["lines"][0].shape[1]))
