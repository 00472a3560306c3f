"""Experiment configuration (the port's copy of ``contrastive_lift_tpu/config.py``).

Keeps the reference's knob names (reference: config/template/panopli_paper.yaml:1-92)
so users of the original hydra configs can port experiment files 1:1, but uses a
plain dataclass + YAML overlay instead of hydra (no dynamic config tree — every
knob is a typed field, unknown keys are an error).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple


@dataclass
class Config:
    # experiment / bookkeeping
    experiment: str = "fast_dev"
    seed: Optional[int] = 42
    save_every_n_train_steps: int = 500
    sanity_steps: int = -1       # val frames rendered before training (-1: all)
    max_epoch: int = 10
    val_check_percent: float = 1.0   # fraction of val frames per validation
    val_check_interval: float = 1.0  # >1: validate every N epochs; <1: N times/epoch
    resume: Optional[str] = None
    subsample_frames: int = 1

    # distilled (DINO) feature field
    use_distilled_features_semantic: bool = False
    use_distilled_features_instance: bool = False
    feature_stop_grad: bool = False
    feature_optimization_end_epoch: int = 5
    feature_type: str = "nearest"

    # semantics
    segment_grouping_mode: str = "argmax_conf"  # none|argmax_conf|argmax_noconf|prob_conf|prob_noconf
    semantic_weight_mode: str = "softmax"       # none|softmax|argmax
    late_semantic_optimization: int = 1
    use_symmetric_ce: bool = False
    probabilistic_ce_mode: str = "TTAConf"      # TTAConf|NoTTAConf|none
    # accepted-but-inert, mirroring the reference: its trainer passes
    # use_feature_reg to the model with the comment "this is NOT actually
    # used" (train_panopli_tensorf.py:59), and lambda_instances appears only
    # in panopli_paper.yaml:30 (the instance losses are added unweighted).
    # Kept so reference config files load unchanged.
    use_feature_regularization: bool = False
    lambda_feat: float = 0.04
    ce_alpha: float = 0.85
    ce_beta: float = 0.15

    # optimization
    lr: float = 5e-4
    lambda_segment: float = 1.2
    lambda_semantics: float = 0.1
    lambda_instances: float = 0.1
    lambda_rgb: float = 1.0
    lambda_dist_reg: float = 0.005
    # optional depth supervision (no reference equivalent — the reference
    # loads depth but never supervises with it); 0.0 = reference behavior
    lambda_depth: float = 0.0
    weight_class_0: float = 0.0
    weight_decay: float = 1e-8
    stop_semantic_grad: bool = True
    use_mlp_for_semantics: bool = True
    use_mlp_for_instances: bool = True
    decay_step: List[int] = field(default_factory=lambda: [9, 10])
    decay_gamma: float = 0.5
    warmup_epochs: int = 0
    warmup_multiplier: float = 1.0

    # batching
    batch_size: int = 2048
    max_rays_instances: int = 1024
    max_rays_segments: int = 1024
    batch_size_contrastive: int = 1
    batch_size_segments: int = 32
    max_instances: int = 25
    chunk: int = 2048
    # rays per checkpointed segment-pass chunk. The reference uses 16384
    # (template/panopli_paper.yaml:49) on a 40 GB A100; the v5e remat
    # working set is ~chunk * n_samples * 256 * 12 bytes (three live
    # [chunk*S, 256] layer activations in the rematted MLP backward), so
    # 16384 at 128^3/443 samples wants ~21 GB and OOMs a 16 GB chip.
    chunk_segment: int = 4096
    num_workers: int = 8         # host threads that build the native ray pool
    logger: str = "none"        # none|tensorboard|wandb
    overfit: bool = False

    # grid
    min_grid_dim: int = 128
    max_grid_dim: int = 192
    pe_sem: int = 0
    pe_ins: int = 0

    # regularizers
    lambda_tv_density: float = 0.1
    lambda_tv_semantics: float = 0.02
    lambda_tv_appearance: float = 0.01
    lambda_tv_instances: float = 0.02
    lambda_tv_distilled_features: float = 0.1
    bbox_aabb_reset_epochs: List[int] = field(default_factory=lambda: [1, 2, 3])
    grid_upscale_epochs: List[int] = field(default_factory=lambda: [1, 2, 3, 4])
    instance_optimization_epoch: int = 3
    segment_optimization_epoch: int = 6

    # instance loss
    instance_loss_mode: str = "linear_assignment"  # linear_assignment|contrastive|slow_fast
    use_delta: bool = False
    temperature: float = 100.0
    optimize_instance_only: bool = False
    use_DINO_style: bool = False
    use_proj: bool = False

    # rendering
    perturb: float = 1.0
    max_depth: float = 5.0
    reweight_fg: bool = False

    # data
    dataset_class: str = "panopli"   # panopli|mos|synthetic
    dataset_root: str = "data/scene"
    image_dim: Tuple[int, int] = (512, 512)
    visualized_indices: Optional[List[int]] = None

    # TPU-specific additions (no reference equivalent)
    data_axis: str = "data"              # mesh axis name for ray sharding
    n_data_shards: int = 1               # devices on the data axis (0 = all)
    max_labels_per_image: int = 128      # static pad for per-image instance labels
    precision: str = "fp32"              # fp32|bf16 for head MLP compute
    fused_aux_density: bool = True       # fused dense-grid density for the
                                         # stop-gradient (instance/segment) passes
    # differentiable densified grids for the MAIN phase too: density (and
    # features) gradients flow through the densify einsums + one cell-corner
    # gather per sample instead of 18 small-table VM gathers; the backward
    # is a scatter-add into the dense grid + matmul transposes. Exact (same
    # function, same gradients — tested:
    # test_fused_main_density_gradients_match_direct). ADOPTED as the
    # default in round 4: on-chip A/B at the reference operating point
    # (bench.py --train, 128^3, 2048 rays) measured 2.283 -> 3.462 main-
    # phase steps/s (+52%, PERFORMANCE.md round-4 train adjudication).
    fused_main_density: bool = True
    # two-level empty-space skipping at inference (renderer/render.py): test
    # coarse stride-sample segments against the occupancy upper bound and
    # evaluate density only in the nearest max_segments occupied ones.
    # coarse_stride=0 disables. Error bound: skipped samples sit at the
    # occ_alpha_thres alpha floor (tests/test_two_level.py); at 16/24 the
    # measured error on a surface field is rgb p99 ~1e-3 (PERFORMANCE.md).
    coarse_stride: int = 16
    max_segments: int = 24
    # third ESS level (renderer sub_stride/max_subsegments): sub-segment
    # tests against the one-voxel-margin occupancy; 0 disables. At 8/24 the
    # measured fidelity on a surface field equals the two-level path
    # (PERFORMANCE.md).
    sub_stride: int = 8
    max_subsegments: int = 24
    # two-level empty-space skipping for the STOP-GRAD training passes
    # (instance + segment renders — train/step.py): their density is frozen
    # within the step, so the same conservative-occupancy argument as
    # inference applies; only samples at the alpha floor are skipped (bounded
    # drift, unlike head_topk_train). Stride is in samples at the TRAINING
    # step ratio: 8 keeps the level-1 test conservative at step_ratio 0.5
    # ((stride/2)*ratio + 1 interp voxel = 3 <= the 4-voxel block dilation).
    # 0 disables (exact dense sampling, reference-parity mode). Caveat: on a
    # field still above the alpha floor EVERYWHERE the nearest-N-occupied
    # budget degrades to a nearest-samples prefix; the aux phases only start
    # at instance_optimization_epoch (several trained epochs in), where
    # fields are carved — set 0 for experiments that move that epoch to 0.
    ess_train_stride: int = 8
    ess_train_segments: int = 32
    # opt-in train-time top-k head compaction (renderer _aux_topk /
    # render_rays): heads evaluate only the k highest-weight samples per ray.
    # Exact once the field is surface-peaked (same contract as inference
    # top-k); 0 = off (default — early-training fields are not yet peaked,
    # and off preserves step-for-step reference parity).
    head_topk_train: int = 0
    # auto-size the train-time head top-k per stage (Trainer
    # _calibrate_aux_topk): k = max per-ray count of samples above
    # raymarch_weight_thres on a probe batch, with margin, re-probed every
    # epoch. The reference itself evaluates heads only on above-threshold
    # samples (panopli_tensoRF_renderer.py:103), so the compaction is exact
    # while counts stay <= k; once active it compacts the aux (instance/
    # segment) passes AND the main-phase heads, and the per-step
    # aux_head_tail / main_head_tail metrics record any overflow (0.0 =
    # exact). Applies only when head_topk_train == 0 and the instance/
    # segment gates are on (earlier epochs stay dense — exact reference
    # parity while the field carves fastest); an empty probe (cnt == 0)
    # also stays dense. The probe uses its own (seed, epoch) RNG, so the
    # training batch stream is unchanged by the feature.
    head_topk_train_auto: bool = True

    def __post_init__(self):
        if isinstance(self.image_dim, int):
            self.image_dim = (self.image_dim, self.image_dim)
        if isinstance(self.image_dim, list):
            self.image_dim = tuple(self.image_dim)

    # The reference adds late_semantic_optimization to the instance/segment epochs
    # at trainer construction (reference: trainer/train_panopli_tensorf.py:46-47).
    def resolve_epochs(self) -> "Config":
        out = dataclasses.replace(self)
        out.instance_optimization_epoch = self.instance_optimization_epoch + self.late_semantic_optimization
        out.segment_optimization_epoch = self.segment_optimization_epoch + self.late_semantic_optimization
        return out

    @property
    def dim_feature_instance(self) -> int:
        # slow_fast renders [fast, slow] concatenated
        # (reference: trainer/train_panopli_tensorf.py:57)
        return 2 * self.max_instances if self.instance_loss_mode == "slow_fast" else self.max_instances

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2, default=str))


def _coerce(value, ftype):
    if ftype in (int, float, str, bool) and value is not None:
        return ftype(value)
    return value


def load_config(path=None, overrides: Optional[dict] = None) -> Config:
    """Build a Config from an optional YAML/JSON file plus a dict of overrides.

    Override keys must be existing Config fields (typo safety, unlike OmegaConf).
    """
    data = {}
    if path is not None:
        text = Path(path).read_text()
        if str(path).endswith(".json"):
            data = json.loads(text)
        else:
            import yaml  # lazy: only needed for YAML configs
            data = yaml.safe_load(text) or {}
    if overrides:
        data.update(overrides)
    # knobs present in the reference template that the reference itself never
    # reads (noise_std/decay_noise defined at panopli_paper.yaml:76-77, dead;
    # save_epoch commented out at trainer/__init__.py:91): accept ported yamls
    # but warn instead of silently carrying no-op fields.
    for dead in ("noise_std", "decay_noise", "save_epoch"):
        if dead in data:
            import warnings
            warnings.warn(f"config key {dead!r} is unused (dead in the "
                          "reference too); ignoring", stacklevel=2)
            data.pop(dead)
    known = {f.name: f for f in dataclasses.fields(Config)}
    unknown = set(data) - set(known)
    if unknown:
        raise KeyError(f"Unknown config keys: {sorted(unknown)}")
    return Config(**data)


def parse_cli_overrides(pairs: List[str]) -> dict:
    """Parse ``key=value`` CLI overrides with JSON-style value parsing."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"Override must be key=value, got {pair!r}")
        key, value = pair.split("=", 1)
        try:
            out[key] = json.loads(value)
        except json.JSONDecodeError:
            out[key] = value
    return out
