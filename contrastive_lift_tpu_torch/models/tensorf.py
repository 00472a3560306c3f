"""TensoRF panoptic field, apply side: config, positional encoding, MLP heads.

Port of the inference half of ``contrastive_lift_tpu/models/tensorf.py``.
Parameters are the JAX package's tree with torch tensors at the leaves
(``io/convert.py::params_from_numpy``); linear layers keep the JAX layout
``x @ w + b`` with ``w`` as [in, out]. Grid-branch features come from the
dense grids of ``ops/fused_grid.py`` (``feats=``); sampling the VM factors
directly, initialization and the grid lifecycle belong to training, a later
slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


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
    (The JAX package wraps the same function in activation checkpointing
    for its backward pass, which inference does not need.)"""
    layers = params["layers"]
    h = x.to(compute_dtype)
    for i, layer in enumerate(layers):
        h = h @ layer["w"].to(compute_dtype) + layer["b"].to(compute_dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h.to(torch.float32)


def _require_feats(cfg_flag: bool, feats, branch: str):
    if not cfg_flag and feats is None:
        raise NotImplementedError(
            f"{branch} grid branch without precomputed feats (direct VM "
            "sampling is not ported; pass the dense-grid features)")


def render_appearance(params, cfg: TensoRFConfig, viewdirs, xyz,
                      compute_dtype=torch.float32, feats=None) -> torch.Tensor:
    """RGB head on the dense-grid appearance features ``feats``. Input order:
    [feat, viewdirs, PE(feat), PE(viewdirs)]."""
    _require_feats(False, feats, "appearance")
    indata = [feats, viewdirs]
    if cfg.pe_feat > 0:
        indata.append(positional_encoding(feats, cfg.pe_feat))
    if cfg.pe_view > 0:
        indata.append(positional_encoding(viewdirs, cfg.pe_view))
    out = mlp_apply(params["appearance_mlp"], torch.cat(indata, -1),
                    compute_dtype)
    return torch.sigmoid(out)


def _head_input(cfg, pe, xyz_or_feat, distilled):
    indata = [xyz_or_feat]
    if pe > 0:
        indata.append(positional_encoding(xyz_or_feat, pe))
    if distilled is not None:
        indata.append(distilled)
    return torch.cat(indata, -1)


def render_semantics(params, cfg: TensoRFConfig, xyz, distilled=None,
                     compute_dtype=torch.float32, feats=None) -> torch.Tensor:
    """Semantic head over xyz (use_semantic_mlp) or grid features."""
    _require_feats(cfg.use_semantic_mlp, feats, "semantic")
    feat, pe = (xyz, cfg.pe_sem) if cfg.use_semantic_mlp else (feats, 0)
    d = distilled if cfg.use_distilled_features_semantic else None
    out = mlp_apply(params["semantic_mlp"], _head_input(cfg, pe, feat, d),
                    compute_dtype)
    if cfg.semantic_output_softmax:
        out = torch.softmax(out, dim=-1)
    return out


def render_instances(params, cfg: TensoRFConfig, xyz, distilled=None,
                     compute_dtype=torch.float32, feats=None) -> torch.Tensor:
    """Instance head; in slow_fast mode returns [fast, slow] concatenated."""
    _require_feats(cfg.use_instance_mlp, feats, "instance")
    feat, pe = (xyz, cfg.pe_ins) if cfg.use_instance_mlp else (feats, 0)
    d = distilled if cfg.use_distilled_features_instance else None
    mlp_in = _head_input(cfg, pe, feat, d)
    out = mlp_apply(params["instance_mlp"]["fast"], mlp_in, compute_dtype)
    if cfg.slow_fast_mode:
        slow = mlp_apply(params["instance_mlp"]["slow"], mlp_in, compute_dtype)
        out = torch.cat([out, slow], dim=-1)
    return out
