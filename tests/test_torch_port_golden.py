"""The JAX goldens of the r5b render, which the port is held to on the card.

``write_golden()`` runs the JAX package eagerly on the CPU with the PQ gate's
dense fp32 config (``tools/pq_fidelity_gate.py``: no empty-space skipping, no
top-k, fp32 heads and atlas) on the 4 val frames of the r5b scene, clusters
the fast instance embeddings and scores PQ^scene. It writes the maps at every
12th ray (2,048 rays) and the scores to
``contrastive_lift_tpu_torch/testdata/r5b_dense_golden.npz``, which
``chip_smoke.py`` reads with numpy. Beside them it records how the jitted
JAX render differs from the eager one (see ``write_golden``). Regenerate with

    JAX_PLATFORMS=cpu python tests/test_torch_port_golden.py

``write_production_golden()`` renders the same frames eagerly on the
production path, at the PQ gate's production point
(``inference/fidelity.py::production_config``: ``render_frames`` defaults,
top-8 bf16 heads, chunks of 4,096 rays), and writes
``contrastive_lift_tpu_torch/testdata/r5b_production_golden.npz``; add the
argument ``production`` to the command above.

``write_train_step_golden()`` takes one training step of r5b with the JAX
package, eagerly: resumed from ``final.npz`` and its optimizer state, on
r5b's own configuration (``artifacts/e2e_r5b_tpu/config.json``) and
synthetic scene, at the checkpoint's epoch (every phase open), with the
calibrated head budget, the first batches of the sampler seed and the draws
of the step's key. It writes
``contrastive_lift_tpu_torch/testdata/r5b_train_step_golden.npz``: the seed,
the draws, the budget, every loss and guardrail metric, and per parameter
leaf the sketches (``train/resume.py::leaf_sketch``) of its main-phase and
instance-phase gradients, of its value after the step and of its change;
add the argument ``train``.

``write_stage_golden()`` runs on ``final.npz`` what the JAX ``Trainer``
runs at a shrink epoch and then at r5b's last upscale epoch, as the Trainer
runs it (``dense_alpha`` jitted, the rest eagerly): the dilated occupancy of
``update_bbox_and_shrink`` (its occupied count, and the dilated alpha on
and just outside each face of the occupied box), the new grid_dim, t_l,
b_r and AABB, the voxel schedule of r5b's config, and for each of its
counts the target resolution of the shrunk AABB and the sketches of every
plane and line after ``upsample_volume_grid`` to it. It writes
``contrastive_lift_tpu_torch/testdata/r5b_stage_golden.npz``; add the
argument ``stage``.

``write_cli_golden()`` runs the JAX package's render and evaluate CLIs on
r5b as a user's run: r5b's synthetic scene written in the MOS layout
(``inference/fidelity.py::write_mos_scene``, PNG colour that PIL reads
pixel for pixel as it was written) and a run directory with r5b's
config pointing at it (``cli_run_dir``), rendered eagerly with
``CLI_ARGS`` (64x96, 4,096-ray chunks, every 4th of the 14 test frames),
once with mean-shift and once with ``--use_dbscan``, each scored by the
evaluate CLI. It writes
``contrastive_lift_tpu_torch/testdata/r5b_cli_golden.npz``: the calibrated
budgets, the mean-shift run's ``pred_semantics`` and its
``instance_features.npy`` at every 12th ray, both runs' scores, and every
3rd point of the HDBSCAN sample of the thing features with the labels
scikit-learn gives it at a third of the CLI's min_cluster_size; add the
argument ``cli``.

``write_tools_golden()`` runs the JAX package's tools eagerly on the same
scene laid out as files (``inference/fidelity.py::tools_run_dir``: r5b's
config rendering every 4th test frame): ``cli/find_bandwidth.py`` on every
18th train frame (the reference's 50-value MOS grid), ``cli/
extract_centroids.py`` at its best bandwidth, ``cli/render.py`` with those
centroids and ``cli/evaluate.py``, ``cli/visualize_bboxes.py`` with the mbr
and the aabb method, ``cli/render_legacy.py`` on the test frames and on a
4-pose orbit, and ``renderer/editing.py::render_edited`` with each edit on
every 12th ray of the first test frame and the mbr box of the largest
volume. It writes ``contrastive_lift_tpu_torch/testdata/
r5b_tools_golden.npz``: the PQ curve and best value, the centroids, the
cached-centroid render's budgets, predictions and scores, both box sets,
every 8th back-projected point of the mbr run with its instance id and the
JAX boxes of those points, the legacy PNGs and budgets, the edit rays, box,
move and maps; add the argument ``tools``.

``write_options_golden()`` renders the same frames as the production
golden once per render option of ``inference/fidelity.py::OPTIONS`` (the
production point with one change each: the L1 cascade, no termination so
that the calibration picks heavy/light bucketing, iter and rank head
selection, unique-cell dedup of 6 cells, span gathers of 4 rows, baked
heads), eagerly, clusters and scores each, and writes
``contrastive_lift_tpu_torch/testdata/r5b_options_golden.npz``: per option
the maps at every 12th ray, the scores, the calibrated budgets, the
guardrail maxima and warnings; add the argument ``options`` (about 6 min).

``write_preprocess_golden()`` writes a raw ScanNet capture at ScanNet's own
sizes (``inference/fidelity.py::write_raw_scannet``: 12 frames of 968x1296
colour, encoded by PIL at quality 90, 480x640 depth, uint16 labels,
Mask2Former dumps), runs the JAX package's ``preprocess_scannet`` on it
(every frame streamed, keyframe window 2, 480x640) and its PanopLi reader
on the tree, and writes ``contrastive_lift_tpu_torch/testdata/
scannet_preprocess_golden.npz``: the ``.sens`` file's sha256, every file
of the tree with its digest (``fidelity.file_digest``: JPEG, txt and json
bytes, PNG headers and PIL's pixels, npz arrays, pickled objects), and the
reader's arrays as digests with every 509th ray; the same again under
``cut_`` for the scene cut to 2 raw frames (keyframe window 1); add the
argument ``preprocess`` (about 20 s).

``write_codec_golden()`` writes one JPEG of each kind the JAX package
reads through PIL and the scene writer does not write
(``inference/fidelity.py::CODEC_KINDS``: RGB-coded, CMYK, YCCK, 4:4:0 and
4:1:1 chroma, a progressive file cut where libjpeg block-smooths,
sequential and progressive arithmetic coding, lossless) at 480x640, by
PIL or by the hand-written writers of ``tests/test_torch_port_codecs.py``,
and writes ``contrastive_lift_tpu_torch/testdata/codec_golden.npz``: the
files, PIL's mode, shape and pixels of each (the digest of the whole and
its top-left corner), the JAX package's ``_load_rgb`` of the RGB-coded and
the CMYK frame at 60x80, and PIL's ``convert("L")`` of the CMYK frame;
add the argument ``codecs`` (a few seconds).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# as the other port test files: Tier-1 runs several workers on the host
torch.set_num_threads(2)

from contrastive_lift_tpu_torch.inference.fidelity import (  # noqa: E402
    BANDWIDTH, BUDGET_FIELDS, CHUNK, OPTIONS, PRODUCTION_CHUNK, R5B_CKPT,
    R5B_SCENE, dense_config, guardrail, production_config, recorded_budgets)

GOLDEN = ROOT / "contrastive_lift_tpu_torch" / "testdata" / "r5b_dense_golden.npz"
PRODUCTION_GOLDEN = GOLDEN.with_name("r5b_production_golden.npz")
TRAIN_GOLDEN = GOLDEN.with_name("r5b_train_step_golden.npz")
STAGE_GOLDEN = GOLDEN.with_name("r5b_stage_golden.npz")
CLI_GOLDEN = GOLDEN.with_name("r5b_cli_golden.npz")
TOOLS_GOLDEN = GOLDEN.with_name("r5b_tools_golden.npz")
OPTIONS_GOLDEN = GOLDEN.with_name("r5b_options_golden.npz")
DISTILLED_GOLDEN = GOLDEN.with_name("r5b_distilled_golden.npz")
PREPROCESS_GOLDEN = GOLDEN.with_name("scannet_preprocess_golden.npz")
CODEC_GOLDEN = GOLDEN.with_name("codec_golden.npz")
RAY_STRIDE = 12
MAP_KEYS = ("rgb", "semantics", "instances", "depth")
# a golden ray counts as moved by jit where a map differs by more than this
JIT_ATOL = 1e-4
COMMAND = "JAX_PLATFORMS=cpu python tests/test_torch_port_golden.py"
PRODUCTION_COMMAND = COMMAND + " production"
TRAIN_COMMAND = COMMAND + " train"
STAGE_COMMAND = COMMAND + " stage"
CLI_COMMAND = COMMAND + " cli"
TOOLS_COMMAND = COMMAND + " tools"
OPTIONS_COMMAND = COMMAND + " options"
DISTILLED_COMMAND = COMMAND + " distilled"
PREPROCESS_COMMAND = COMMAND + " preprocess"
CODECS_COMMAND = COMMAND + " codecs"
# the preprocessing golden's records: (prefix, raw frames, keyframe window)
PREPROCESS_RECORDS = (("", 12, 2), ("cut_", 2, 1))
# the training golden's sampler seed
TRAIN_SEED = 0


def write_golden(path=GOLDEN) -> dict:
    """Render, cluster and score r5b with the JAX package; save the golden.

    The golden is the eager render, op by op: under jit XLA fuses
    ``o + d * z`` into multiply-adds whose rounding differs from separate
    ops. The first sample of every ray lies exactly on the AABB face, so
    that last bit decides whether it counts as in the box, and a few rays
    move. Separate ops are what the port computes on every device, so the
    eager golden holds the port to its arithmetic, not to a fusion choice.
    The jitted render is recorded beside it: ``jit_ray_index`` (positions in
    ``ray_index`` where a map moves by more than ``JIT_ATOL``), the jitted
    maps at those rays (``jit_<map>``), the largest difference at every other
    golden ray (``jit_max_abs_diff_rest``) and the jitted scores.
    """
    import jax
    jax.config.update("jax_platforms", "cpu")
    from contrastive_lift_tpu.inference.render import (
        load_model_for_inference, render_frames)
    from tools.pq_fidelity_gate import cluster_maps, e2e_config, e2e_scene, pq_for

    scene = e2e_scene(*R5B_SCENE)
    cfg = e2e_config(scene.image_dim)
    params, mcfg, rcfg, state_r, _ = load_model_for_inference(
        R5B_CKPT, cfg, scene.num_semantic_classes, step_ratio=0.25,
        head_topk=None)
    rcfg = dense_config(rcfg)
    n_rays = sum(len(f.rays) for f in scene.val_frames)
    idx = np.arange(0, n_rays, RAY_STRIDE)

    def run():
        frames = render_frames(params, mcfg, rcfg, state_r, scene.val_frames,
                               chunk=CHUNK)
        onehot = cluster_maps(frames, scene, BANDWIDTH, cfg.max_instances)
        scores = pq_for(frames, onehot, scene, cfg.max_instances)
        return ({k: np.concatenate([f[k] for f in frames])[idx]
                 for k in MAP_KEYS}, scores)

    with jax.disable_jit():
        out, (pq, sq, rq, pq_m) = run()
    jit_maps, (jit_pq, _, _, jit_pq_m) = run()
    diff = np.stack([np.abs(jit_maps[k] - out[k]).reshape(len(idx), -1)
                     .max(axis=1) for k in MAP_KEYS], axis=1)
    moved = np.flatnonzero((diff > JIT_ATOL).any(axis=1))
    rest = np.delete(diff, moved, axis=0)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    image_dim, num_train, checker_freq = R5B_SCENE
    out.update(ray_index=idx, pq_scene=pq, pq_masked=pq_m, sq=sq, rq=rq,
               n_samples=rcfg.n_samples, bandwidth=BANDWIDTH, chunk=CHUNK,
               image_dim=np.asarray(image_dim), num_train=num_train,
               checker_freq=checker_freq, jit=False, commit=commit,
               command=COMMAND, jit_ray_index=moved,
               jit_max_abs_diff_rest=float(rest.max()) if rest.size else 0.0,
               jit_pq_scene=jit_pq, jit_pq_masked=jit_pq_m,
               **{f"jit_{k}": jit_maps[k][moved] for k in MAP_KEYS})
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def _popcount(words) -> int:
    return int(np.unpackbits(np.ascontiguousarray(words).view(np.uint8)).sum())


def write_production_golden(path=PRODUCTION_GOLDEN) -> dict:
    """Render r5b's val frames with the JAX package on the production path,
    eagerly (for the AABB-face reason of ``write_golden``), cluster and
    score; save the golden.

    ``render_frames`` runs with its defaults at ``production_config`` in
    chunks of ``PRODUCTION_CHUNK`` rays. The golden holds the maps at every
    12th ray, the scores, the calibrated budget fields (``budget_<field>``
    for each of ``BUDGET_FIELDS``), the set bits of both occupancy bit tables
    and the number of feature slots, the largest ``budget_tail`` and
    ``head_tail`` over the chunks, the guardrail warnings, and its
    provenance."""
    from tools.pq_fidelity_gate import e2e_config, e2e_scene

    scene = e2e_scene(*R5B_SCENE)
    out = _jax_production_render(R5B_CKPT, e2e_config(scene.image_dim),
                                 scene)
    out.pop("first_chunk")
    out.update(commit=_commit(), command=PRODUCTION_COMMAND)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def _commit() -> str:
    return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                          capture_output=True, text=True).stdout.strip()


def _jax_production_render(ckpt, cfg, scene) -> dict:
    """What a production golden holds of the JAX package's eager production
    render of ``scene``'s val frames from ``ckpt`` with ``cfg`` (see
    ``write_production_golden``), without its provenance; ``first_chunk``
    is the output of ``render_rays`` on the first chunk."""
    import warnings

    import jax
    jax.config.update("jax_platforms", "cpu")
    from contrastive_lift_tpu.inference import render as jrender
    from tools.pq_fidelity_gate import cluster_maps, pq_for

    params, mcfg, rcfg, state_r, _ = jrender.load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, step_ratio=0.25,
        head_topk=8)
    rcfg = production_config(rcfg)
    n_rays = sum(len(f.rays) for f in scene.val_frames)
    idx = np.arange(0, n_rays, RAY_STRIDE)
    calibrated, tails, outs = [], [], []
    R = jrender.R
    real_calibrate, real_render_rays = R.calibrate_budgets, R.render_rays

    def calibrate_spy(mcfg, rcfg, state, probe, fused, **kw):
        out = real_calibrate(mcfg, rcfg, state, probe, fused, **kw)
        calibrated.append((out, fused))
        return out

    def render_rays_spy(*args, **kw):
        out = real_render_rays(*args, **kw)
        tails.append((float(out["budget_tail"]), float(out["head_tail"])))
        if not outs:
            outs.append({k: np.asarray(v) for k, v in out.items()})
        return out

    R.calibrate_budgets, R.render_rays = calibrate_spy, render_rays_spy
    try:
        with jax.disable_jit(), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            frames = jrender.render_frames(params, mcfg, rcfg, state_r,
                                           scene.val_frames,
                                           chunk=PRODUCTION_CHUNK)
    finally:
        R.calibrate_budgets, R.render_rays = real_calibrate, real_render_rays
    onehot = cluster_maps(frames, scene, BANDWIDTH, cfg.max_instances)
    pq, sq, rq, pq_m = pq_for(frames, onehot, scene, cfg.max_instances)
    (budgets, fused), = calibrated
    image_dim, num_train, checker_freq = R5B_SCENE
    out = {k: np.concatenate([f[k] for f in frames])[idx] for k in MAP_KEYS}
    out.update(
        ray_index=idx, pq_scene=pq, pq_masked=pq_m, sq=sq, rq=rq,
        n_samples=rcfg.n_samples, bandwidth=BANDWIDTH, chunk=PRODUCTION_CHUNK,
        head_topk=rcfg.head_topk, head_topk_semins=rcfg.head_topk_semins,
        head_dtype=rcfg.head_dtype, image_dim=np.asarray(image_dim),
        num_train=num_train, checker_freq=checker_freq,
        **{f"budget_{f}": getattr(budgets, f) for f in BUDGET_FIELDS},
        coarse_bits=_popcount(np.asarray(fused.occ_bits_group)),
        tight_bits=_popcount(np.asarray(fused.occ_bits_group_tight)),
        feature_slots=int(np.count_nonzero(np.asarray(fused.slot_map)[:, 0])),
        n_chunks=len(tails),
        budget_tail_max=max(t[0] for t in tails),
        head_tail_max=max(t[1] for t in tails),
        warnings=np.asarray([str(w.message) for w in caught
                             if w.filename == jrender.__file__], dtype=str),
        jit=False, first_chunk=outs[0])
    return out


def write_options_golden(path=OPTIONS_GOLDEN) -> dict:
    """Render r5b's val frames with the JAX package eagerly once per render
    option of ``OPTIONS`` (the production point with one change each),
    cluster and score each; save the golden.

    Per option ``<name>``: the maps at every 12th ray (``<name>_rgb``, ...),
    the scores, the calibrated budget fields (``<name>_budget_<field>``),
    the largest ``budget_tail``, ``head_tail`` and ``dedup_tail`` over the
    chunks, the guardrail warnings and the chunk count; beside them the span
    option's atlas rows per span and the least that r5b's step admits
    (``span_rows_required``), and the golden's provenance."""
    import dataclasses
    import warnings

    import jax
    jax.config.update("jax_platforms", "cpu")
    from contrastive_lift_tpu.inference import render as jrender
    from contrastive_lift_tpu.ops.fused_grid import span_rows_required
    from tools.pq_fidelity_gate import cluster_maps, e2e_config, e2e_scene, pq_for

    scene = e2e_scene(*R5B_SCENE)
    cfg = e2e_config(scene.image_dim)
    params, mcfg, rcfg, state_r, _ = jrender.load_model_for_inference(
        R5B_CKPT, cfg, scene.num_semantic_classes, step_ratio=0.25,
        head_topk=8)
    rcfg = production_config(rcfg)
    n_rays = sum(len(f.rays) for f in scene.val_frames)
    idx = np.arange(0, n_rays, RAY_STRIDE)
    R = jrender.R
    real_render_rays = R.render_rays
    image_dim, num_train, checker_freq = R5B_SCENE
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    out = dict(
        ray_index=idx, options=np.asarray(list(OPTIONS), dtype=str),
        n_samples=rcfg.n_samples, bandwidth=BANDWIDTH, chunk=PRODUCTION_CHUNK,
        head_topk=rcfg.head_topk, head_topk_semins=rcfg.head_topk_semins,
        head_dtype=rcfg.head_dtype, image_dim=np.asarray(image_dim),
        num_train=num_train, checker_freq=checker_freq,
        span_fine_span_rows=OPTIONS["span"][0]["fine_span_rows"],
        span_rows_required=span_rows_required(
            np.asarray(state_r.units), float(state_r.step_size),
            rcfg.sub_stride),
        jit=False, commit=commit, command=OPTIONS_COMMAND)
    for name, (changes, render_kw) in OPTIONS.items():
        tails = []

        def render_rays_spy(*args, **kw):
            res = real_render_rays(*args, **kw)
            tails.append([float(res[k]) for k in ("budget_tail", "head_tail",
                                                  "dedup_tail")])
            return res

        R.render_rays = render_rays_spy
        try:
            with jax.disable_jit(), recorded_budgets(R) as calibrated, \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                frames = jrender.render_frames(
                    params, mcfg, dataclasses.replace(rcfg, **changes),
                    state_r, scene.val_frames, chunk=PRODUCTION_CHUNK,
                    **render_kw)
        finally:
            R.render_rays = real_render_rays
        onehot = cluster_maps(frames, scene, BANDWIDTH, cfg.max_instances)
        pq, sq, rq, pq_m = pq_for(frames, onehot, scene, cfg.max_instances)
        budgets, = calibrated
        tails = np.asarray(tails)
        out.update({f"{name}_{k}": np.concatenate([f[k] for f in frames])[idx]
                    for k in MAP_KEYS})
        out.update({f"{name}_budget_{f}": getattr(budgets, f)
                    for f in BUDGET_FIELDS})
        out.update({
            f"{name}_pq_scene": pq, f"{name}_pq_masked": pq_m,
            f"{name}_sq": sq, f"{name}_rq": rq, f"{name}_n_chunks": len(tails),
            f"{name}_budget_tail_max": tails[:, 0].max(),
            f"{name}_head_tail_max": tails[:, 1].max(),
            f"{name}_dedup_tail_max": tails[:, 2].max(),
            f"{name}_warnings": np.asarray(
                [str(w.message) for w in caught
                 if w.filename == jrender.__file__], dtype=str)})
        print(name, {k[len(name) + 1:]: out[k] for k in out
                     if k.startswith(name + "_") and np.size(out[k]) < 30},
              flush=True)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def write_train_step_golden(path=TRAIN_GOLDEN) -> dict:
    """One eager JAX training step of r5b, resumed from its checkpoint; save
    the golden (see the module docstring). The gradients are those of the
    step's two ``value_and_grad`` calls, recomputed here with the JAX
    package's phase losses on the same inputs; the step itself
    (``make_train_step``) gives the metrics and the parameters after it,
    and its main loss must equal the recomputed one."""
    from contrastive_lift_tpu.config import load_config
    from contrastive_lift_tpu_torch.inference.fidelity import R5B_CONFIG
    from contrastive_lift_tpu_torch.train.resume import TRAIN_METRICS
    from tools.pq_fidelity_gate import e2e_scene

    out = _jax_train_step(R5B_CKPT, load_config(R5B_CONFIG),
                          e2e_scene(*R5B_SCENE), TRAIN_METRICS)
    out.update(commit=_commit(), command=TRAIN_COMMAND)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def _jax_train_step(ckpt, cfg, scene, metric_names) -> dict:
    """What a training golden holds of one eager JAX step resumed from
    ``ckpt`` with ``cfg`` on ``scene`` (see ``write_train_step_golden``),
    without its provenance."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from contrastive_lift_tpu.data.base import (InstanceBundleSampler,
                                                RayPoolSampler,
                                                SegmentBundleSampler)
    from contrastive_lift_tpu.factory import (class_weights_for,
                                              make_model_config,
                                              make_render_config)
    from contrastive_lift_tpu.io.checkpoint import (load_checkpoint,
                                                    restore_opt_state)
    from contrastive_lift_tpu.renderer import render as R
    from contrastive_lift_tpu.train import step as S
    from contrastive_lift_tpu.train.loop import Trainer
    from contrastive_lift_tpu.train.schedule import lr_scale_for_epoch
    from contrastive_lift_tpu.train.state import (TrainState, ema_update_slow,
                                                  init_train_state,
                                                  make_optimizers)
    from contrastive_lift_tpu_torch.train.resume import leaf_sketches
    from contrastive_lift_tpu_torch.utils.tree import (path_str,
                                                       tree_leaves_with_path)
    from types import SimpleNamespace

    params, meta = load_checkpoint(ckpt)
    params = jax.tree.map(jnp.asarray, params)
    grid_dim = tuple(meta["grid_dim"])
    bbox = np.asarray(meta["bbox_aabb"], np.float32)
    epoch, global_step = int(meta["epoch"]), int(meta["global_step"])
    if any(e < epoch for e in cfg.grid_upscale_epochs):
        cfg.weight_decay = 0.0          # as Trainer.restore
    mcfg = make_model_config(cfg, scene.num_semantic_classes)
    rcfg = make_render_config(cfg, bbox, grid_dim, mcfg,
                              white_bg=scene.white_bg)
    state_r = R.make_render_state(bbox, grid_dim)
    weights = class_weights_for(cfg, scene.segmentation)
    fresh = init_train_state(cfg, params)
    opt_main, opt_inst = restore_opt_state(
        (fresh.opt_state_main, fresh.opt_state_inst), meta["opt_leaves"])
    state = TrainState(params, opt_main, opt_inst,
                       jnp.asarray(global_step, jnp.int32))
    gates = S.gates_for_epoch(cfg, epoch)
    lr_scale = lr_scale_for_epoch(epoch, cfg.decay_step, cfg.decay_gamma,
                                  cfg.warmup_epochs, cfg.warmup_multiplier)
    lambda_dist = cfg.lambda_dist_reg * (1 - np.exp(-0.25 * epoch))
    frames = scene.train_frames
    main_s = RayPoolSampler(frames, scene.num_semantic_classes,
                            load_feats=mcfg.use_distilled)
    inst_s = InstanceBundleSampler(frames, cfg.max_rays_instances,
                                   cfg.max_labels_per_image)
    seg_s = SegmentBundleSampler(frames, cfg.max_rays_segments)
    stub = SimpleNamespace(cfg=cfg, rcfg=rcfg, main_sampler=main_s, mcfg=mcfg,
                           grid_dim=grid_dim, state_r=state_r,
                           state=state, _count_fn=None, _count_key=None)
    rng = np.random.default_rng(TRAIN_SEED)
    bm = main_s.sample(rng, cfg.batch_size)
    bi = inst_s.sample(rng, cfg.batch_size_contrastive)
    bs = seg_s.sample(rng, cfg.batch_size_segments)
    key = jax.random.PRNGKey(global_step)       # as Trainer.train_epoch
    rng_main, rng_seg, rng_inst = jax.random.split(key, 3)
    rng_pts, rng_bg = jax.random.split(rng_main)
    n_chunk = min(cfg.chunk_segment, len(bs["rays"]))
    draws = dict(
        draw_main_jitter=np.asarray(jax.random.uniform(
            rng_pts, (cfg.batch_size, 1)))[:, 0],
        draw_main_coin=np.asarray(jax.random.uniform(rng_bg, ())),
        draw_seg_jitter=np.asarray(jax.random.uniform(rng_seg, (n_chunk,))),
        draw_inst_jitter=np.stack([
            np.asarray(jax.random.uniform(k, (bi["rays"].shape[1],)))
            for k in jax.random.split(rng_inst, bi["rays"].shape[0])]))
    main_tx, inst_tx, labels = make_optimizers(cfg, params)

    with jax.disable_jit():
        k = Trainer._calibrate_aux_topk(stub, gates, epoch)

        def loss_fn(p):
            loss, m = S.main_phase_loss(p, cfg, mcfg, rcfg, state_r, gates,
                                        bm, rng_main, lambda_dist, weights,
                                        head_topk=k)
            seg, _, _ = S.segment_phase_loss(p, cfg, mcfg, rcfg, state_r, bs,
                                             rng_seg, weights, k)
            return loss + cfg.lambda_semantics * cfg.lambda_segment * seg, m

        (loss_main, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, _ = main_tx.update(grads, opt_main, params)
        p1 = jax.tree.map(lambda a, u: a + u * lr_scale, params, updates)

        def inst_loss_fn(p):
            return S.instance_phase_loss(p, cfg, mcfg, rcfg, state_r, bi,
                                         rng_inst, k)[0]

        grads_i = jax.grad(inst_loss_fn)(p1)
        step = S.make_train_step(cfg, mcfg, rcfg, gates, weights, params,
                                 donate=False, aux_head_topk=k)
        new_state, metrics = step(state, state_r, bm, bi, bs, key, lr_scale,
                                  lambda_dist)
    assert abs(float(metrics["loss_main"]) - float(loss_main)) <= 1e-6 * abs(
        float(loss_main))
    # the gradient each chain applies: zero on the leaves it does not train
    # (a distilled input the instance heads take carries the instance loss
    # back to the feature branch, which only the main chain trains)
    trains = {"main": ("main_grid_wd", "main_grid", "main_net"),
              "inst": ("inst_grid", "inst_net", "inst_slow")}
    label_of = dict(tree_leaves_with_path(labels))

    def applied(g, chain):
        return [(p, v if label_of[p] in trains[chain] else np.zeros(v.shape))
                for p, v in tree_leaves_with_path(g)]

    leaves = [tree_leaves_with_path(params), applied(grads, "main"),
              applied(grads_i, "inst"), tree_leaves_with_path(new_state.params)]
    out = {"leaf_paths": np.asarray([path_str(p) for p, _ in leaves[0]])}
    sketches = [leaf_sketches(i, *(np.asarray(t[i][1]) for t in leaves[1:]),
                              np.asarray(leaves[3][i][1])
                              - np.asarray(leaves[0][i][1]))
                for i in range(len(leaves[0]))]
    for j, name in enumerate(("grad_main", "grad_inst", "after", "delta")):
        out[f"sketch_{name}"] = np.stack([s[j] for s in sketches])
    image_dim, num_train, checker_freq = R5B_SCENE
    out.update(
        {f"metric_{m}": float(metrics[m]) for m in metric_names},
        **draws, seed=TRAIN_SEED, aux_head_topk=k, epoch=epoch,
        global_step=global_step, lr_scale=lr_scale,
        lambda_dist_reg=lambda_dist, n_samples=rcfg.n_samples,
        image_dim=np.asarray(image_dim), num_train=num_train,
        checker_freq=checker_freq, jit=False)
    return out


def write_distilled_golden(path=DISTILLED_GOLDEN) -> dict:
    """r5b with distilled-feature heads grafted on, with the JAX package,
    eagerly; save the golden.

    The checkpoint is ``inference/fidelity.py::write_distilled_checkpoint``'s
    (r5b plus the seeded ``feature`` branch, ``feature_basis``,
    ``feature_mlp`` and 64 input rows on each head's first layer, with
    r5b's optimizer state carried over), the scene r5b's with
    ``distilled_targets``. (a) One training step as
    ``write_train_step_golden`` takes it, with ``distilled_config`` (both
    distilled inputs, the feature gate open at epoch 29): its keys are the
    training golden's (``loss_feat`` among the metrics), its sample count
    ``step_n_samples``. (b) The production render as
    ``write_production_golden`` renders it, with the PQ gate's config and
    the distilled heads: its keys are the production golden's. (c) The
    ``distilled`` map of that render's first chunk (the first 4,096 rays of
    val frame 0) at every 12th ray: ``distilled`` at
    ``distilled_ray_index``."""
    import dataclasses
    import tempfile

    from contrastive_lift_tpu.config import load_config
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    from contrastive_lift_tpu_torch.train.resume import DISTILLED_METRICS
    from tools.pq_fidelity_gate import e2e_config, e2e_scene

    cfg = load_config(fid.R5B_CONFIG, fid.DISTILLED_OVERRIDES)
    cfg.feature_optimization_end_epoch = cfg.max_epoch
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = fid.write_distilled_checkpoint(Path(tmp) / "distilled.npz")
        step = _jax_train_step(
            ckpt, cfg, fid.distilled_targets(e2e_scene(*R5B_SCENE)),
            DISTILLED_METRICS)
        scene = fid.distilled_targets(e2e_scene(*R5B_SCENE))
        out = _jax_production_render(
            ckpt, dataclasses.replace(e2e_config(scene.image_dim),
                                      **fid.DISTILLED_OVERRIDES), scene)
    first = out.pop("first_chunk")
    step["step_n_samples"] = step.pop("n_samples")
    out.update({k: v for k, v in step.items() if k not in out})
    rows = np.arange(0, PRODUCTION_CHUNK, RAY_STRIDE)
    out.update(distilled_ray_index=rows, distilled=first["distilled"][rows],
               distilled_seed=fid.DISTILLED_SEED, commit=_commit(),
               command=DISTILLED_COMMAND)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def write_stage_golden(path=STAGE_GOLDEN) -> dict:
    """The shrink and the upscales of r5b's schedule with the JAX package;
    save the golden (see the module docstring)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from contrastive_lift_tpu.config import load_config
    from contrastive_lift_tpu.factory import make_model_config
    from contrastive_lift_tpu.io.checkpoint import load_checkpoint
    from contrastive_lift_tpu.models import tensorf as tf
    from contrastive_lift_tpu.ops.grid_sample import VECTOR_MODE
    from contrastive_lift_tpu.renderer import occupancy as occ
    from contrastive_lift_tpu.renderer import render as R
    from contrastive_lift_tpu_torch.inference.fidelity import R5B_CONFIG
    from contrastive_lift_tpu_torch.train.resume import leaf_sketches
    from contrastive_lift_tpu_torch.train.stages import (face_alphas,
                                                         grid_leaves)

    cfg = load_config(R5B_CONFIG)
    params, meta = load_checkpoint(R5B_CKPT)
    params = jax.tree.map(jnp.asarray, params)
    mcfg = make_model_config(
        cfg, params["semantic_mlp"]["layers"][-1]["b"].shape[0])
    grid_dim = tuple(meta["grid_dim"])
    state_r = R.make_render_state(np.asarray(meta["bbox_aabb"], np.float32),
                                  grid_dim)
    alpha, _ = occ.dense_alpha(params, mcfg, state_r, grid_dim)
    dilated = np.asarray(occ._max_pool3d(jnp.clip(alpha, 0.0, 1.0)))
    occupied = dilated >= 0.0075
    new_params, new_state, new_grid = occ.update_bbox_and_shrink(
        params, mcfg, state_r, grid_dim)
    # the crop, read back from the density lines (line i runs along axis
    # VECTOR_MODE[i])
    t_l, b_r = [0] * 3, [0] * 3
    for i, v in enumerate(VECTOR_MODE):
        old = np.asarray(params["density"]["lines"][i])
        new = np.asarray(new_params["density"]["lines"][i])
        n = new.shape[1]
        hits = [s for s in range(old.shape[1] - n + 1)
                if np.array_equal(old[:, s:s + n], new)]
        assert len(hits) == 1, (i, hits)
        t_l[v], b_r[v] = hits[0], hits[0] + n
    schedule = occ.grid_upscale_voxel_counts(
        cfg.min_grid_dim, cfg.max_grid_dim, len(cfg.grid_upscale_epochs))
    targets = [occ.get_target_resolution(new_state, c) for c in schedule]
    sketches = []
    for target in targets:
        leaves = grid_leaves(tf.upsample_volume_grid(new_params, target))
        sketches.append([leaf_sketches(i, np.asarray(t))[0]
                         for i, (_, t) in enumerate(leaves)])
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    out = dict(
        occupied=int(occupied.sum()),
        face_alphas=face_alphas(dilated, occupied),
        grid_dim=np.asarray(new_grid), t_l=np.asarray(t_l),
        b_r=np.asarray(b_r), bbox_aabb=np.asarray(new_state.bbox_aabb),
        voxel_schedule=np.asarray(schedule), target_res=np.asarray(targets),
        leaf_paths=np.asarray([p for p, _ in leaves]),
        sketches=np.asarray(sketches),
        source_grid_dim=np.asarray(grid_dim), commit=commit,
        command=STAGE_COMMAND)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def write_cli_golden(path=CLI_GOLDEN) -> dict:
    """The JAX package's render and evaluate CLIs on r5b's scene and
    checkpoint laid out as files, eagerly; save the golden (see the module
    docstring)."""
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")
    from sklearn.cluster import HDBSCAN

    from contrastive_lift_tpu.cli import evaluate as evaluate_cli
    from contrastive_lift_tpu.cli import render as render_cli
    from contrastive_lift_tpu.inference import render as jrender
    from contrastive_lift_tpu_torch.inference.fidelity import (
        CLI_ARGS, CLI_CLUSTERINGS, CLI_METRICS, HDBSCAN_STRIDE, cli_run_dir,
        e2e_scene, hdbscan_sample, write_mos_scene)

    out = {}
    real = jrender.R.calibrate_budgets
    calibrated = []

    def spy(*args, **kwargs):
        calibrated.append(real(*args, **kwargs))
        return calibrated[-1]

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        scene_root = write_mos_scene(e2e_scene(*R5B_SCENE), tmp / "scene")
        ckpt = cli_run_dir(tmp / "run", scene_root)
        h, w = CLI_ARGS[1:3]
        jrender.R.calibrate_budgets = spy
        try:
            for name, extra in CLI_CLUSTERINGS.items():
                with jax.disable_jit():
                    render_cli.main(["--ckpt_path", str(ckpt), *CLI_ARGS,
                                     *extra, "--output_dir", str(tmp / name)])
                evaluate_cli.main(["--root_path", str(scene_root),
                                   "--exp_path", str(tmp / name),
                                   "--image_size", h, w])
                lines = (tmp / name / "metrics.txt").read_text().splitlines()
                scores = dict(line.split(": ") for line in lines)
                for key, src in zip(CLI_METRICS, ("iou", "pq", "sq", "rq")):
                    out[f"{name}_{key}"] = float(scores[src])
        finally:
            jrender.R.calibrate_budgets = real
        budgets = [{f: getattr(c, f) for f in BUDGET_FIELDS}
                   for c in calibrated]
        assert all(b == budgets[0] for b in budgets), budgets
        names = sorted(p.stem for p in (tmp / "meanshift" / "pred_semantics")
                       .iterdir())
        from PIL import Image
        pred = np.stack([np.array(Image.open(
            tmp / "meanshift" / "pred_semantics" / f"{n}.png")) for n in names])
        inst = np.load(tmp / "meanshift" / "instance_features.npy")
        sample = hdbscan_sample(np.load(tmp / "dbscan" / "thing_features.npy"))
    idx = np.arange(0, len(inst), RAY_STRIDE)
    kept = sample[::HDBSCAN_STRIDE].astype(np.float32)
    # the CLI's min_cluster_size, scaled to the kept share of the points
    min_size = 500 // HDBSCAN_STRIDE
    labels = HDBSCAN(min_cluster_size=min_size, min_samples=1,
                     allow_single_cluster=True, copy=True).fit(kept).labels_
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    out.update(**{f"budget_{f}": v for f, v in budgets[0].items()},
               frame_names=np.asarray(names), pred_semantics=pred,
               ray_index=idx, instance_features=inst[idx],
               hdbscan_sample=kept, hdbscan_labels=labels.astype(np.int16),
               hdbscan_points=len(sample), cluster_size=500,
               hdbscan_min_cluster_size=min_size,
               cli_args=np.asarray(CLI_ARGS), jit=False, commit=commit,
               command=CLI_COMMAND)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def write_tools_golden(path=TOOLS_GOLDEN) -> dict:
    """The JAX package's tools on r5b's scene and checkpoint laid out as
    files, eagerly; save the golden (see the module docstring)."""
    import contextlib
    import io
    import json
    import pickle
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")
    from PIL import Image

    from contrastive_lift_tpu.cli import evaluate as evaluate_cli
    from contrastive_lift_tpu.cli import extract_centroids as extract_cli
    from contrastive_lift_tpu.cli import find_bandwidth as bandwidth_cli
    from contrastive_lift_tpu.cli import render as render_cli
    from contrastive_lift_tpu.cli import render_legacy as legacy_cli
    from contrastive_lift_tpu.cli import visualize_bboxes as bboxes_cli
    from contrastive_lift_tpu.config import load_config as j_load_config
    from contrastive_lift_tpu.data import load_scene as j_load_scene
    from contrastive_lift_tpu.inference import bboxes as jbboxes
    from contrastive_lift_tpu.inference import render as jrender
    from contrastive_lift_tpu.inference.calibrate import sweep_values
    from contrastive_lift_tpu.renderer import editing as jedit
    from contrastive_lift_tpu_torch.inference import fidelity as fid

    def pngs(folder, names):
        return np.stack([np.array(Image.open(folder / f"{n}.png"))
                         for n in names])

    out = {}
    with tempfile.TemporaryDirectory() as tmp, jax.disable_jit():
        tmp = Path(tmp)
        scene_root = fid.write_mos_scene(fid.e2e_scene(*R5B_SCENE),
                                         tmp / "scene")
        ckpt = fid.tools_run_dir(tmp / "run", scene_root)
        common = ["--ckpt_path", str(ckpt), *fid.TOOLS_ARGS]
        h, w = (int(x) for x in fid.TOOLS_ARGS[1:3])
        sub = ["--subsample", str(fid.TOOLS_SUBSAMPLE)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bandwidth_cli.main(common + sub + ["--output_dir",
                                               str(tmp / "bandwidth")])
        text = buf.getvalue()
        best = json.loads(text[text.rindex("\n{") + 1:])
        curve = [(float(a.split(": ")[1]), float(b.split(": ")[1]))
                 for a, b in (line.split(", ") for line in text.splitlines()
                              if line.startswith("value: "))]
        cfg = j_load_config(tmp / "run" / "config.json")
        assert [v for v, _ in curve] == list(sweep_values(cfg, False, True))
        feats = np.load(tmp / "bandwidth" / "all_thing_features_train.npy")
        out.update(bw_values=np.asarray([v for v, _ in curve]),
                   bw_pq=np.asarray([p for _, p in curve]),
                   bw_best_value=best["best_value"],
                   bw_best_pq=best["best_pq"],
                   bw_thing_points=int((feats[:, 0] == -np.inf).sum()))

        pkl = tmp / "all_centroids.pkl"
        extract_cli.main(common + sub + ["--bandwidth",
                                         repr(best["best_value"]),
                                         "--output_path", str(pkl)])
        with open(pkl, "rb") as f:
            centroids = pickle.load(f)
        out["centroid_classes"] = np.asarray(sorted(centroids), np.int64)
        for c, v in centroids.items():
            out[f"centroids_{c}"] = np.asarray(v, np.float32)

        with fid.recorded_budgets(jrender.R) as calibrated:
            render_cli.main(["--ckpt_path", str(ckpt), *fid.CLI_ARGS,
                             "--cached_centroids_path", str(pkl),
                             "--output_dir", str(tmp / "cached")])
        evaluate_cli.main(["--root_path", str(scene_root), "--exp_path",
                           str(tmp / "cached"), "--image_size", str(h),
                           str(w)])
        scores = dict(line.split(": ") for line in
                      (tmp / "cached" / "metrics.txt").read_text()
                      .splitlines())
        for key, src in zip(fid.CLI_METRICS, ("iou", "pq", "sq", "rq")):
            out[f"cached_{key}"] = float(scores[src])
        out.update({f"cached_budget_{f}": v for f, v in
                    fid.budgets_of(calibrated[-1]).items()})
        names = sorted(p.stem for p in (tmp / "cached" / "pred_semantics")
                       .iterdir())
        out["test_names"] = np.asarray(names)
        out["cached_pred_semantics"] = pngs(tmp / "cached" / "pred_semantics",
                                            names)

        real_boxes = bboxes_cli.instance_bounding_boxes
        seen = []

        def spy(points, ids, **kw):
            seen.append((points, ids))
            return real_boxes(points, ids, **kw)

        bboxes_cli.instance_bounding_boxes = spy
        try:
            for method in fid.BOX_RUN_METHODS:
                bboxes_cli.main(common + ["--method", method, "--output_dir",
                                          str(tmp / f"boxes_{method}")])
                boxes = json.loads((tmp / f"boxes_{method}" / "boxes.json")
                                   .read_text())
                for f, v in fid.box_arrays(boxes).items():
                    out[f"boxes_{method}_{f}"] = v
        finally:
            bboxes_cli.instance_bounding_boxes = real_boxes
        points, ids = seen[0]
        out["box_points"] = np.asarray(points[::fid.BOX_POINT_STRIDE],
                                       np.float32)
        out["box_ids"] = np.asarray(ids[::fid.BOX_POINT_STRIDE], np.int16)
        for method in fid.BOX_RUN_METHODS:
            sub_boxes = jbboxes.instance_bounding_boxes(
                out["box_points"], out["box_ids"].astype(np.int64),
                method=method)
            for f, v in fid.box_arrays(sub_boxes).items():
                out[f"boxes_sub_{method}_{f}"] = v

        for tag, extra in (("test", ["--subsample", str(
                fid.TOOLS_RUN_OVERRIDES["subsample_frames"])]), (
                "trajectory", ["--render_trajectory", "--trajectory_frames",
                               str(fid.TRAJECTORY_FRAMES)])):
            with fid.recorded_budgets(jrender.R) as calibrated:
                legacy_cli.main(common + extra + ["--output_dir",
                                                  str(tmp / f"legacy_{tag}")])
            folder = tmp / f"legacy_{tag}"
            names = sorted(p.stem for p in (folder / "pred_semantics")
                           .iterdir())
            out[f"legacy_{tag}_names"] = np.asarray(names)
            out[f"legacy_{tag}_semantics"] = pngs(folder / "pred_semantics",
                                                  names)
            out[f"legacy_{tag}_surrogate"] = pngs(folder / "pred_surrogateid",
                                                  names)
            out.update({f"legacy_{tag}_budget_{f}": v for f, v in
                        fid.budgets_of(calibrated[-1]).items()})

        # the edits: the model as the render CLI loads it, the first test
        # frame's rays, the mbr box of the largest volume
        cfg.image_dim = (h, w)
        cfg.subsample_frames = fid.TOOLS_RUN_OVERRIDES["subsample_frames"]
        scene = j_load_scene(cfg, load_train=False)
        params, mcfg, rcfg, state_r, meta = jrender.load_model_for_inference(
            ckpt, cfg, scene.num_semantic_classes, white_bg=scene.white_bg)
        rays = scene.val_frames[0].rays[::fid.EDIT_RAY_STRIDE].astype(
            np.float32)
        k = int(np.argmax(np.prod(out["boxes_mbr_extent"], axis=1)))
        box = {f: out[f"boxes_mbr_{f}"][k].astype(np.float32)
               for f in ("extent", "position", "orientation")}
        out.update(edit_rays=rays, edit_translation=np.asarray(
            fid.EDIT_TRANSLATION, np.float32), edit_rotation=fid.edit_rotation(),
            **{f"edit_{f}": v for f, v in box.items()})
        for kind in fid.EDIT_KINDS:
            kw = ({"translation": out["edit_translation"],
                   "rotation": out["edit_rotation"]}
                  if kind in ("duplicate", "manipulate") else {})
            maps = jedit.render_edited(params, mcfg, rcfg, state_r, rays,
                                       kind, box, **kw)
            for key in MAP_KEYS:
                out[f"edit_{kind}_{key}"] = np.asarray(maps[key], np.float32)
        aabb = np.asarray(meta["bbox_aabb"], np.float32)
        out["aabb_extent"] = float((aabb[1] - aabb[0]).max())
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    out.update(jit=False, commit=commit, command=TOOLS_COMMAND)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def test_golden_file_layout():
    """The committed golden holds the maps at every 12th ray of the 4 val
    frames, finite, with the scores and its provenance."""
    with np.load(GOLDEN) as g:
        n = 4 * 64 * 96 // RAY_STRIDE
        np.testing.assert_array_equal(g["ray_index"],
                                      np.arange(0, 4 * 64 * 96, RAY_STRIDE))
        for key, width in (("rgb", 3), ("semantics", 2), ("instances", 6)):
            assert g[key].shape == (n, width)
            assert np.isfinite(g[key]).all()
        assert g["depth"].shape == (n,)
        assert int(g["n_samples"]) == 879
        for key in ("pq_scene", "pq_masked", "sq", "rq"):
            assert 0.0 <= float(g[key]) <= 1.0
        assert len(str(g["commit"])) == 40
        assert str(g["command"]) == COMMAND


def test_golden_records_jit_difference():
    """The jitted JAX render differs from the eager golden at no more than
    two of the 2,048 rays (the first sample on the AABB face, see
    write_golden), agrees within JIT_ATOL everywhere else, and gives the
    same PQ^scene and masked PQ."""
    with np.load(GOLDEN) as g:
        moved = g["jit_ray_index"]
        assert len(moved) <= 2
        for key in MAP_KEYS:
            assert g[f"jit_{key}"].shape == (len(moved),) + g[key].shape[1:]
            assert np.isfinite(g[f"jit_{key}"]).all()
        assert float(g["jit_max_abs_diff_rest"]) <= JIT_ATOL
        for key in ("pq_scene", "pq_masked"):
            assert float(g[f"jit_{key}"]) == float(g[key])


def test_production_golden_file_layout():
    """The committed production golden holds the maps at every 12th ray of
    the 4 val frames, finite, with the scores, the calibrated budgets, the
    occupancy counts, the guardrails and its provenance."""
    with np.load(PRODUCTION_GOLDEN) as g:
        n = 4 * 64 * 96 // RAY_STRIDE
        np.testing.assert_array_equal(g["ray_index"],
                                      np.arange(0, 4 * 64 * 96, RAY_STRIDE))
        for key, width in (("rgb", 3), ("semantics", 2), ("instances", 6)):
            assert g[key].shape == (n, width)
            assert np.isfinite(g[key]).all()
        assert g["depth"].shape == (n,)
        assert int(g["n_samples"]) == 879
        assert int(g["chunk"]) == PRODUCTION_CHUNK
        assert (int(g["head_topk"]), int(g["head_topk_semins"]),
                str(g["head_dtype"])) == (8, 8, "bfloat16")
        for key in ("pq_scene", "pq_masked", "sq", "rq"):
            assert 0.0 <= float(g[key]) <= 1.0
        for field in BUDGET_FIELDS:
            assert g[f"budget_{field}"].shape == ()
        assert not bool(g["budget_use_l1"])
        assert 0 < int(g["budget_term_first"]) < int(g["budget_max_subsegments"])
        # 4 frames of 6,144 rays, each padded to 2 chunks
        assert int(g["n_chunks"]) == 8
        assert 0 < int(g["feature_slots"]) <= int(g["tight_bits"])
        assert 0 < int(g["tight_bits"]) <= int(g["coarse_bits"])
        for key in ("budget_tail_max", "head_tail_max"):
            assert 0.0 <= float(g[key]) <= 1.0
        assert g["warnings"].ndim == 1
        assert len(str(g["commit"])) == 40
        assert str(g["command"]) == PRODUCTION_COMMAND


def test_port_on_cpu_matches_production_golden():
    """The port's production render of r5b on the CPU (run_production):
    calibrated budgets, occupancy counts and guardrail warnings as in the
    golden, maps within the bf16-head bar 3e-2, PQ^scene and masked PQ within
    the gate's 0.5 pt."""
    from contrastive_lift_tpu_torch.inference.fidelity import (
        e2e_scene, run_production)

    res = run_production(R5B_CKPT, e2e_scene(*R5B_SCENE), device="cpu")
    with np.load(PRODUCTION_GOLDEN) as g:
        for field in BUDGET_FIELDS:
            assert getattr(res["rcfg"], field) == g[f"budget_{field}"].item()
        assert [guardrail(m) for m in res["warnings"]] == [
            guardrail(str(m)) for m in g["warnings"]]
        for key in MAP_KEYS:
            got = np.concatenate([f[key] for f in res["maps"]])[g["ray_index"]]
            np.testing.assert_allclose(got, g[key], atol=3e-2, rtol=0,
                                       err_msg=key)
        for key in ("pq_scene", "pq_masked"):
            assert abs(res[key] - float(g[key])) <= 0.005


def test_options_golden_layout():
    """The committed options golden: for each of fidelity.OPTIONS the maps
    at every 12th ray of the 4 val frames, finite, the scores, the
    calibrated budgets (the L1 budget under "l1", the light budget under
    "no_term", termination otherwise), the guardrails and warnings; the span
    option's rows as many as r5b's step needs; its provenance."""
    with np.load(OPTIONS_GOLDEN) as g:
        assert list(g["options"]) == list(OPTIONS)
        n = 4 * 64 * 96 // RAY_STRIDE
        np.testing.assert_array_equal(g["ray_index"],
                                      np.arange(0, 4 * 64 * 96, RAY_STRIDE))
        assert (int(g["head_topk"]), int(g["head_topk_semins"]),
                str(g["head_dtype"])) == (8, 8, "bfloat16")
        assert int(g["chunk"]) == PRODUCTION_CHUNK
        assert int(g["span_fine_span_rows"]) == OPTIONS["span"][0][
            "fine_span_rows"] == int(g["span_rows_required"])
        for name in OPTIONS:
            for key, width in (("rgb", 3), ("semantics", 2), ("instances", 6)):
                assert g[f"{name}_{key}"].shape == (n, width)
                assert np.isfinite(g[f"{name}_{key}"]).all()
            assert g[f"{name}_depth"].shape == (n,)
            for key in ("pq_scene", "pq_masked", "sq", "rq"):
                assert 0.0 <= float(g[f"{name}_{key}"]) <= 1.0
            for field in BUDGET_FIELDS:
                assert g[f"{name}_budget_{field}"].shape == ()
            assert bool(g[f"{name}_budget_use_l1"]) == (name == "l1")
            light = int(g[f"{name}_budget_max_subsegments_light"])
            term = int(g[f"{name}_budget_term_first"])
            assert (light > 0, term > 0) == ((True, False) if name == "no_term"
                                             else (False, True))
            assert int(g[f"{name}_n_chunks"]) == 8
            assert (float(g[f"{name}_dedup_tail_max"]) > 0) == (name == "dedup")
            assert g[f"{name}_warnings"].ndim == 1
        assert len(str(g["commit"])) == 40
        assert str(g["command"]) == OPTIONS_COMMAND


def _check_option_on_cpu(option):
    from contrastive_lift_tpu_torch.inference.fidelity import (
        e2e_scene, run_production)

    res = run_production(R5B_CKPT, e2e_scene(*R5B_SCENE), device="cpu",
                         option=option)
    with np.load(OPTIONS_GOLDEN) as g:
        for field in BUDGET_FIELDS:
            assert getattr(res["rcfg"], field) == g[
                f"{option}_budget_{field}"].item(), field
        assert [guardrail(m) for m in res["warnings"]] == [
            guardrail(str(m)) for m in g[f"{option}_warnings"]]
        for key in MAP_KEYS:
            got = np.concatenate([f[key] for f in res["maps"]])[g["ray_index"]]
            np.testing.assert_allclose(got, g[f"{option}_{key}"], atol=3e-2,
                                       rtol=0, err_msg=key)
        for key in ("pq_scene", "pq_masked"):
            assert abs(res[key] - float(g[f"{option}_{key}"])) <= 0.005, key


# about 45 s each on the CPU, 5 min for the seven: Tier-1 runs the span
# option's, which goes through the span form's plain version
@pytest.mark.parametrize("option", [
    pytest.param(o, marks=() if o == "span" else pytest.mark.slow)
    for o in OPTIONS])
def test_port_on_cpu_matches_options_golden(option):
    """The port's render of r5b on the CPU with each option
    (``run_production(option=)``): calibrated budgets and guardrail
    warnings as in the golden, maps within the bf16-head bar 3e-2, PQ^scene
    and masked PQ within the gate's 0.5 pt."""
    _check_option_on_cpu(option)


def test_train_step_golden_layout():
    """The committed training golden: r5b's step at its checkpoint's epoch
    with every phase open, the draws of the step's key at the batch shapes,
    the calibrated budget, finite metrics, and four sketches of each of the
    checkpoint's parameter leaves; under 1 MB."""
    from contrastive_lift_tpu_torch.io.checkpoint import load_checkpoint
    from contrastive_lift_tpu_torch.train.resume import (N_PROBES, SKETCHES,
                                                         TRAIN_METRICS)
    from contrastive_lift_tpu_torch.utils.tree import (path_str,
                                                       tree_leaves_with_path)
    assert TRAIN_GOLDEN.stat().st_size < 1 << 20
    params, meta = load_checkpoint(R5B_CKPT)
    paths = [path_str(p) for p, _ in tree_leaves_with_path(params)]
    with np.load(TRAIN_GOLDEN) as g:
        assert list(g["leaf_paths"]) == paths
        for name in SKETCHES:
            assert g[f"sketch_{name}"].shape == (len(paths), 1 + N_PROBES)
            assert np.isfinite(g[f"sketch_{name}"]).all()
        for m in TRAIN_METRICS:
            assert np.isfinite(float(g[f"metric_{m}"])), m
        assert g["draw_main_jitter"].shape == (2048,)
        assert g["draw_main_coin"].shape == ()
        assert g["draw_seg_jitter"].shape == (2048,)
        assert g["draw_inst_jitter"].shape == (1, 1024)
        for key in ("draw_main_jitter", "draw_seg_jitter", "draw_inst_jitter"):
            assert 0.0 <= g[key].min() and g[key].max() < 1.0
        assert int(g["epoch"]) == meta["epoch"]
        assert int(g["global_step"]) == meta["global_step"]
        assert 0 < int(g["aux_head_topk"]) < int(g["n_samples"])
        assert int(g["seed"]) == TRAIN_SEED
        assert not bool(g["jit"])
        assert len(str(g["commit"])) == 40
        assert str(g["command"]) == TRAIN_COMMAND
        # every phase moved the parameters it trains, and no other
        moved = g["sketch_delta"][:, 0] > 0
        trained = (g["sketch_grad_main"][:, 0] > 0) | (
            g["sketch_grad_inst"][:, 0] > 0)
        slow = np.char.startswith(g["leaf_paths"], "instance_mlp/slow")
        np.testing.assert_array_equal(moved, trained | slow)


def test_port_on_cpu_matches_train_step_golden():
    """The port's r5b training step on the CPU (train/resume.py::golden_step)
    against the eager JAX golden: the calibrated budget equal, every metric
    within rtol 2e-3, every leaf's sketches within 4.5e-2."""
    from contrastive_lift_tpu_torch.config import load_config
    from contrastive_lift_tpu_torch.inference.fidelity import (R5B_CONFIG,
                                                               e2e_scene)
    from contrastive_lift_tpu_torch.train.resume import (check_train_step,
                                                         golden_step)
    with np.load(TRAIN_GOLDEN) as g:
        gold = {k: g[k] for k in g.files}
    res = golden_step(R5B_CKPT, load_config(R5B_CONFIG),
                      e2e_scene(*R5B_SCENE), gold, device="cpu")
    assert check_train_step(res, gold) == []


def test_stage_golden_layout():
    """The committed stage golden: r5b's grid shrinks inside the checkpoint
    grid, its schedule is r5b's, the upsampled leaves are every plane and
    line of the checkpoint, the face alphas bracket the threshold; under
    200 KB."""
    from contrastive_lift_tpu_torch.io.checkpoint import load_checkpoint
    from contrastive_lift_tpu_torch.train.resume import N_PROBES
    from contrastive_lift_tpu_torch.train.stages import grid_leaves
    assert STAGE_GOLDEN.stat().st_size < 200_000
    params, meta = load_checkpoint(R5B_CKPT)
    with np.load(STAGE_GOLDEN) as g:
        np.testing.assert_array_equal(g["source_grid_dim"], meta["grid_dim"])
        assert (g["b_r"] - g["t_l"] == g["grid_dim"]).all()
        assert (g["t_l"] >= 0).all() and (g["b_r"] <= g["source_grid_dim"]).all()
        box = g["bbox_aabb"]
        old = np.asarray(meta["bbox_aabb"], np.float32)
        assert box.dtype == np.float32 and box.shape == (2, 3)
        assert (box[0] >= old[0]).all() and (box[1] <= old[1]).all()
        assert list(g["voxel_schedule"]) == [741455, 2097152]
        for count, res in zip(g["voxel_schedule"], g["target_res"]):
            assert 0.96 * count <= np.prod(res) <= count
        assert 0 < int(g["occupied"]) <= np.prod(meta["grid_dim"])
        assert list(g["leaf_paths"]) == [p for p, _ in grid_leaves(params)]
        assert g["sketches"].shape == (2, len(g["leaf_paths"]), 1 + N_PROBES)
        assert np.isfinite(g["sketches"]).all()
        inside = g["face_alphas"][:, 0]
        outside = g["face_alphas"][:, 1]
        assert (inside >= 0.0075).all()
        assert (np.isnan(outside) | (outside < 0.0075)).all()
        assert len(str(g["commit"])) == 40
        assert str(g["command"]) == STAGE_COMMAND


def test_port_on_cpu_matches_stage_golden():
    """The port's shrink and upscale of r5b on the CPU
    (train/stages.py::stage_changes) within the golden's bars."""
    from contrastive_lift_tpu_torch.config import load_config
    from contrastive_lift_tpu_torch.inference.fidelity import R5B_CONFIG
    from contrastive_lift_tpu_torch.train.stages import (check_stages,
                                                         stage_changes)
    res = stage_changes(R5B_CKPT, load_config(R5B_CONFIG), device="cpu")
    with np.load(STAGE_GOLDEN) as g:
        bad, notes = check_stages(res, g)
        np.testing.assert_array_equal(res["bbox_aabb"], g["bbox_aabb"])
        np.testing.assert_array_equal(res["face_alphas"] >= 0.0075,
                                      g["face_alphas"] >= 0.0075)
    assert bad == [] and notes == []


def test_cli_golden_layout():
    """The committed CLI golden: 4 frames of 64x96 predictions, the
    instance features at every 12th ray, finite scores for both clusterings,
    the budgets of the production path, and scikit-learn's HDBSCAN labels of
    every 3rd sample point; under 200 KB."""
    from contrastive_lift_tpu_torch.inference.fidelity import (
        CLI_ARGS, CLI_CLUSTERINGS, CLI_METRICS, HDBSCAN_STRIDE)
    assert CLI_GOLDEN.stat().st_size < 200 << 10
    with np.load(CLI_GOLDEN) as g:
        assert list(g["frame_names"]) == ["0054", "0058", "0062", "0066"]
        assert g["pred_semantics"].shape == (4, 64, 96)
        assert g["pred_semantics"].dtype == np.uint8
        assert g["instance_features"].shape == (2048, 3)
        np.testing.assert_array_equal(g["ray_index"],
                                      np.arange(0, 4 * 64 * 96, RAY_STRIDE))
        for name in CLI_CLUSTERINGS:
            for key in CLI_METRICS:
                assert np.isfinite(float(g[f"{name}_{key}"])), (name, key)
        for field in BUDGET_FIELDS:
            assert g[f"budget_{field}"].shape == ()
        assert 0 < int(g["budget_term_first"]) < int(g["budget_max_subsegments"])
        n = -(-int(g["hdbscan_points"]) // HDBSCAN_STRIDE)
        assert g["hdbscan_sample"].shape == (n, 3)
        assert g["hdbscan_labels"].shape == (n,)
        assert int(g["hdbscan_min_cluster_size"]) == 500 // HDBSCAN_STRIDE
        assert int(g["hdbscan_labels"].max()) >= 1   # at least two clusters
        assert list(g["cli_args"]) == list(CLI_ARGS)
        assert not bool(g["jit"])
        assert len(str(g["commit"])) == 40
        assert str(g["command"]) == CLI_COMMAND


@pytest.mark.parametrize("clustering", [
    "meanshift", pytest.param("dbscan", marks=pytest.mark.slow)])
def test_port_on_cpu_matches_cli_golden(tmp_path, clustering):
    """The port's render and evaluate CLIs on the CPU (``fidelity.run_cli``)
    within the golden's bars (``fidelity.check_cli``), for each clustering.
    Mean-shift takes about 25 s alone; HDBSCAN adds a 24,282-point spanning
    tree on the CPU and about 50 s alone, several minutes beside the other
    Tier-1 workers, so it is marked slow (the card runs both in
    ``chip_smoke.py``)."""
    from contrastive_lift_tpu_torch.inference.fidelity import (
        check_cli, cli_run_dir, e2e_scene, run_cli, write_mos_scene)
    scene_root = write_mos_scene(e2e_scene(*R5B_SCENE), tmp_path / "scene")
    ckpt = cli_run_dir(tmp_path / "run", scene_root)
    res = run_cli(ckpt, scene_root, tmp_path / "out", device="cpu",
                  clusterings=(clustering,))
    with np.load(CLI_GOLDEN) as g:
        bad, measured = check_cli(res, g)
    assert bad == [], measured


def test_port_hdbscan_matches_cli_golden():
    """The port's HDBSCAN on the CPU gives scikit-learn's labels of the
    golden's sample of r5b's thing features, up to a permutation."""
    from contrastive_lift_tpu_torch.inference.fidelity import labels_match
    from contrastive_lift_tpu_torch.inference.hdbscan import hdbscan_labels
    with np.load(CLI_GOLDEN) as g:
        labels = hdbscan_labels(g["hdbscan_sample"],
                                int(g["hdbscan_min_cluster_size"]),
                                device="cpu")
        assert labels_match(labels, g["hdbscan_labels"])


def test_tools_golden_layout():
    """The committed tools golden: the 50-value PQ curve of 18,432 train
    rays, the centroids, the cached-centroid render of the 4 test frames,
    both box sets (as many boxes; ids, positions, extents, orientations),
    every 8th back-projected point, the legacy PNGs of 4 test frames and 4
    orbit poses, the 512 edit rays with their box, move and maps; finite;
    under 300 KB."""
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    assert TOOLS_GOLDEN.stat().st_size < 300 << 10
    with np.load(TOOLS_GOLDEN) as g:
        assert g["bw_values"].shape == g["bw_pq"].shape == (50,)
        assert float(g["bw_best_value"]) in g["bw_values"].tolist()
        assert float(g["bw_best_pq"]) == g["bw_pq"].max() > 0
        assert 10_000 <= int(g["bw_thing_points"]) <= 25_000
        assert len(g["centroid_classes"]) >= 1
        for c in g["centroid_classes"]:
            assert g[f"centroids_{c}"].ndim == 2
            assert g[f"centroids_{c}"].shape[1] == 3
        for field in BUDGET_FIELDS:
            for prefix in ("cached", "legacy_test", "legacy_trajectory"):
                assert g[f"{prefix}_budget_{field}"].shape == ()
        names = ["0054", "0058", "0062", "0066"]
        assert list(g["test_names"]) == list(g["legacy_test_names"]) == names
        assert g["cached_pred_semantics"].shape == (4, 64, 96)
        assert g["cached_pred_semantics"].dtype == np.uint8
        for key in fid.CLI_METRICS:
            assert np.isfinite(float(g[f"cached_{key}"]))
        for prefix in ("boxes_mbr", "boxes_aabb", "boxes_sub_mbr",
                       "boxes_sub_aabb"):
            n = len(g[f"{prefix}_ids"])
            assert n >= 1
            assert g[f"{prefix}_position"].shape == (n, 3)
            assert g[f"{prefix}_extent"].shape == (n, 3)
            assert g[f"{prefix}_orientation"].shape == (n, 3, 3)
        assert len(g["boxes_mbr_ids"]) == len(g["boxes_aabb_ids"])
        assert g["box_points"].shape == (4 * 64 * 96 // 8, 3)
        assert g["box_ids"].shape == (4 * 64 * 96 // 8,)
        for tag, n in (("test", 4), ("trajectory", 4)):
            assert g[f"legacy_{tag}_semantics"].shape == (n, 64, 96)
            assert g[f"legacy_{tag}_semantics"].dtype == np.uint8
            assert g[f"legacy_{tag}_surrogate"].dtype == np.uint16
        assert len(g["legacy_trajectory_names"]) == 4
        assert g["edit_rays"].shape == (64 * 96 // 12, 8)
        for kind in fid.EDIT_KINDS:
            for key, width in (("rgb", 3), ("semantics", 2),
                               ("instances", 6)):
                assert g[f"edit_{kind}_{key}"].shape == (512, width)
            assert g[f"edit_{kind}_depth"].shape == (512,)
            assert all(np.isfinite(g[f"edit_{kind}_{k}"]).all()
                       for k in MAP_KEYS)
        np.testing.assert_array_equal(g["edit_rotation"], fid.edit_rotation())
        assert float(g["aabb_extent"]) > 0
        assert not bool(g["jit"])
        assert len(str(g["commit"])) == 40
        assert str(g["command"]) == TOOLS_COMMAND


@pytest.fixture(scope="module")
def tools_run(tmp_path_factory):
    """r5b's scene in the MOS layout and the tools' run directory."""
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    tmp = tmp_path_factory.mktemp("tools")
    scene_root = fid.write_mos_scene(fid.e2e_scene(*R5B_SCENE), tmp / "scene")
    return tmp, scene_root, fid.tools_run_dir(tmp / "run", scene_root)


def test_port_on_cpu_matches_tools_golden(tools_run):
    """The cheap parts of the tools golden on the CPU: the port's boxes of
    the golden's points (1e-6), the four edits on the first 128 of the
    golden's rays (16 image rows, 48 of them crossing the box;
    ``fidelity.check_edits``: maps within 1e-4, the opacity checks),
    and the legacy render of the first test frame at the golden's budgets
    (semantics on 99.9%, surrogate ids on 99% of the pixels)."""
    import dataclasses

    from contrastive_lift_tpu_torch.inference import fidelity as fid
    from contrastive_lift_tpu_torch.inference.bboxes import (
        instance_bounding_boxes)
    from contrastive_lift_tpu_torch.inference.render import render_frames
    _, _, ckpt = tools_run
    with np.load(TOOLS_GOLDEN) as g:
        for method in fid.BOX_RUN_METHODS:
            got = fid.box_arrays(instance_bounding_boxes(
                g["box_points"], g["box_ids"].astype(np.int64), method=method))
            for f, v in got.items():
                np.testing.assert_allclose(v, g[f"boxes_sub_{method}_{f}"],
                                           atol=1e-6, err_msg=f)
        rows = slice(0, 128)
        edits = fid.run_edits(ckpt, g, device="cpu", rows=rows)
        bad, measured = fid.check_edits(edits, g, rows=rows)
        assert bad == [], measured
        params, mcfg, rcfg, state_r, frames = fid.tools_model(ckpt, "cpu")
        rcfg = dataclasses.replace(rcfg, **{
            f: g[f"legacy_test_budget_{f}"].item() for f in BUDGET_FIELDS})
        out = render_frames(params, mcfg, rcfg, state_r, frames[:1],
                            chunk=PRODUCTION_CHUNK, auto_budget=False,
                            device="cpu")[0]
        assert frames[0].name == str(g["legacy_test_names"][0])
        sem = out["semantics"].argmax(-1).reshape(64, 96)
        inst = out["instances"][:, :3].argmax(-1).reshape(64, 96)
        assert (sem == g["legacy_test_semantics"][0]).mean() >= 0.999
        assert (inst == g["legacy_test_surrogate"][0]).mean() >= 0.99


@pytest.mark.slow
def test_port_tools_on_cpu_match_tools_golden(tools_run):
    """All of the tools phase on the CPU (``fidelity.run_tools``, the 50
    mean-shift runs of the sweep included) within the golden's bars
    (``fidelity.check_tools``), and the imported reference-layout checkpoint
    renders finite maps."""
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    tmp, scene_root, ckpt = tools_run
    res = fid.run_tools(ckpt, scene_root, tmp / "out", device="cpu")
    with np.load(TOOLS_GOLDEN) as g:
        bad, measured = fid.check_tools(res, g)
    assert bad == [], measured
    imported = fid.run_import(tmp / "import", device="cpu")
    assert all(np.isfinite(v).all() for v in imported["maps"].values())


def test_distilled_golden_layout():
    """The committed distilled golden: the training golden's layout for the
    grafted checkpoint's leaves (the feature branch and the widened first
    layers among them) with loss_feat non-zero, the production golden's
    render keys, and the first chunk's distilled map at every 12th ray
    with unit rows where a ray hits; under 1 MB."""
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    from contrastive_lift_tpu_torch.io.checkpoint import load_checkpoint
    from contrastive_lift_tpu_torch.train.resume import (DISTILLED_METRICS,
                                                         N_PROBES, SKETCHES)
    from contrastive_lift_tpu_torch.utils.tree import (path_str,
                                                       tree_leaves_with_path)
    assert DISTILLED_GOLDEN.stat().st_size < 1 << 20
    arrays, meta = load_checkpoint(R5B_CKPT)
    grafted = fid.graft_distilled(arrays, fid.DISTILLED_SEED)
    paths = [path_str(p) for p, _ in tree_leaves_with_path(grafted)]
    with np.load(DISTILLED_GOLDEN) as g:
        assert int(g["distilled_seed"]) == fid.DISTILLED_SEED
        assert list(g["leaf_paths"]) == paths
        assert "feature_mlp/layers/2/w" in paths
        for name in SKETCHES:
            assert g[f"sketch_{name}"].shape == (len(paths), 1 + N_PROBES)
            assert np.isfinite(g[f"sketch_{name}"]).all()
        for m in DISTILLED_METRICS:
            assert np.isfinite(float(g[f"metric_{m}"])), m
        assert float(g["metric_loss_feat"]) > 0
        assert int(g["epoch"]) == meta["epoch"]
        assert int(g["global_step"]) == meta["global_step"]
        assert 0 < int(g["aux_head_topk"]) < int(g["step_n_samples"])
        # the feature branch trained, with gradient and change
        feat = np.char.startswith(g["leaf_paths"], "feature")
        assert (g["sketch_grad_main"][feat, 0] > 0).all()
        assert (g["sketch_delta"][feat, 0] > 0).all()
        n = 4 * 64 * 96 // RAY_STRIDE
        for key, width in (("rgb", 3), ("semantics", 2), ("instances", 6)):
            assert g[key].shape == (n, width)
            assert np.isfinite(g[key]).all()
        assert int(g["n_samples"]) == 879 and int(g["n_chunks"]) == 8
        assert (int(g["head_topk"]), str(g["head_dtype"])) == (8, "bfloat16")
        for field in BUDGET_FIELDS:
            assert g[f"budget_{field}"].shape == ()
        np.testing.assert_array_equal(g["distilled_ray_index"],
                                      np.arange(0, PRODUCTION_CHUNK,
                                                RAY_STRIDE))
        dist = g["distilled"]
        assert dist.shape == (len(g["distilled_ray_index"]), 64)
        norms = np.linalg.norm(dist, axis=-1)
        hit = norms > 0.5
        assert hit.mean() > 0.2
        np.testing.assert_allclose(norms[hit], 1.0, atol=1e-5)
        assert not bool(g["jit"])
        assert len(str(g["commit"])) == 40
        assert str(g["command"]) == DISTILLED_COMMAND


def test_graft_and_targets_are_deterministic():
    """graft_distilled and distilled_targets draw the same arrays from the
    same seed and others from another; the graft keeps r5b's leaves,
    appends its 64 input rows last on each head's first layer, and leaves
    its input untouched; the carried optimizer state keeps r5b's moments
    and step counts, zero for what is new."""
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    from contrastive_lift_tpu_torch.io.checkpoint import load_checkpoint
    from contrastive_lift_tpu_torch.utils.tree import tree_leaves_with_path
    arrays, meta = load_checkpoint(R5B_CKPT)
    before = {p: a.copy() for p, a in tree_leaves_with_path(arrays)}
    a = dict(tree_leaves_with_path(fid.graft_distilled(arrays, 0)))
    b = dict(tree_leaves_with_path(fid.graft_distilled(arrays, 0)))
    c = dict(tree_leaves_with_path(fid.graft_distilled(arrays, 1)))
    assert set(a) == set(b) == set(c)
    for path, want in before.items():
        np.testing.assert_array_equal(dict(tree_leaves_with_path(arrays))[path],
                                      want)
    for path in a:
        np.testing.assert_array_equal(a[path], b[path])
        if path[0].startswith("feature"):
            assert not np.array_equal(a[path], c[path]), path
        elif path in before and a[path].shape == before[path].shape:
            np.testing.assert_array_equal(a[path], before[path])
    assert a[("feature", "planes", 0)].shape == (48, 131, 131)
    assert a[("feature_basis", "w")].shape == (144, 96)
    assert a[("feature_mlp", "layers", 2, "w")].shape == (256, 64)
    for head in fid.DISTILLED_HEAD_INPUTS:
        path = head + ("layers", 0, "w")
        old = before[path]
        assert a[path].shape == (old.shape[0] + 64, old.shape[1])
        np.testing.assert_array_equal(a[path][:old.shape[0]], old)
        bound = 1 / np.sqrt(old.shape[0] + 64)
        new = a[path][old.shape[0]:]
        assert new.std() > bound / 3 and np.abs(new).max() <= bound
    scenes = [fid.distilled_targets(fid.e2e_scene((8, 12), 4, 18.0), seed)
              for seed in (0, 0, 1)]
    for f0, f1, f2 in zip(*(s.train_frames + s.val_frames for s in scenes)):
        assert f0.feats.shape == (96, 64)
        np.testing.assert_array_equal(f0.feats, f1.feats)
        assert not np.array_equal(f0.feats, f2.feats)
        np.testing.assert_allclose(np.linalg.norm(f0.feats, axis=-1), 1.0,
                                   atol=1e-5)
    grafted = fid.graft_distilled(arrays, 0)
    main, inst = fid.graft_opt_state(fid.distilled_config(), arrays, grafted,
                                     meta["opt_leaves"])
    from contrastive_lift_tpu_torch.io.checkpoint import opt_state_leaves
    leaves = opt_state_leaves(main, inst)
    # 13 new leaves in the main chain, a mu and a nu each
    assert len(leaves) == len(meta["opt_leaves"]) + 2 * 13
    mu = main["main_net"].mu
    w0 = mu[("semantic_mlp", "layers", 0, "w")].numpy()
    assert w0.shape == (67, 256)
    assert not w0[3:].any() and w0[:3].any()
    assert not mu[("feature_mlp", "layers", 0, "w")].any()
    # the main chain's first group (main_grid) keeps r5b's step count
    assert int(main["main_grid"].count) == int(meta["opt_leaves"][0]) > 0


# about 60 s on the CPU (the feature branch's factor gradients), and the
# render check below about 70 s: both beyond the Tier-1 budget
@pytest.mark.slow
def test_port_on_cpu_matches_distilled_golden_step(tmp_path):
    """(a) of distilled_r5b on the CPU: the grafted checkpoint's training
    step (train/resume.py::golden_step) against the eager JAX golden: the
    calibrated budget equal, every metric (loss_feat among them) within
    rtol 2e-3, every leaf's sketches within 4.5e-2."""
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    from contrastive_lift_tpu_torch.train.resume import (DISTILLED_METRICS,
                                                         check_train_step,
                                                         golden_step)
    with np.load(DISTILLED_GOLDEN) as g:
        gold = {k: g[k] for k in g.files}
    ckpt = fid.write_distilled_checkpoint(tmp_path / "distilled.npz")
    scene = fid.distilled_targets(fid.e2e_scene(*R5B_SCENE))
    res = golden_step(ckpt, fid.distilled_config(), scene, gold, device="cpu")
    assert res["metrics"]["loss_feat"] > 0
    assert check_train_step(res, gold, DISTILLED_METRICS) == []


@pytest.mark.slow
def test_port_on_cpu_matches_distilled_golden_render(tmp_path):
    """(b) and (c) of distilled_r5b on the CPU: the grafted checkpoint's
    production render with budgets, warnings, maps (3e-2) and PQ^scene
    (0.5 pt) as in the golden, and its first chunk's distilled map within
    3e-2 of the golden's."""
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    ckpt = fid.write_distilled_checkpoint(tmp_path / "distilled.npz")
    scene = fid.distilled_targets(fid.e2e_scene(*R5B_SCENE))
    res = fid.run_production(ckpt, scene, device="cpu",
                             cfg=fid.distilled_render_config(scene.image_dim))
    dist = fid.distilled_chunk(ckpt, scene, device="cpu").numpy()
    with np.load(DISTILLED_GOLDEN) as g:
        for field in BUDGET_FIELDS:
            assert getattr(res["rcfg"], field) == g[f"budget_{field}"].item()
        assert [guardrail(m) for m in res["warnings"]] == [
            guardrail(str(m)) for m in g["warnings"]]
        for key in MAP_KEYS:
            got = np.concatenate([f[key] for f in res["maps"]])[g["ray_index"]]
            np.testing.assert_allclose(got, g[key], atol=3e-2, rtol=0,
                                       err_msg=key)
        for key in ("pq_scene", "pq_masked"):
            assert abs(res[key] - float(g[key])) <= 0.005
        np.testing.assert_allclose(dist[g["distilled_ray_index"]],
                                   g["distilled"], atol=3e-2, rtol=0)


@pytest.mark.slow
def test_golden_regenerates(tmp_path):
    """write_golden() reproduces the committed file: maps within 1e-4 (CPU
    summation order may differ between hosts), scores within the repo's
    0.5 pt PQ bar."""
    fresh = write_golden(tmp_path / "golden.npz")
    with np.load(GOLDEN) as g:
        for key in MAP_KEYS:
            np.testing.assert_allclose(fresh[key], g[key], atol=1e-4)
        for key in ("pq_scene", "pq_masked", "sq", "rq", "jit_pq_scene",
                    "jit_pq_masked"):
            assert abs(fresh[key] - float(g[key])) <= 0.005


@pytest.mark.slow
def test_production_golden_regenerates(tmp_path):
    """write_production_golden() reproduces the committed file: budgets,
    occupancy counts and warnings equal, maps within 1e-4, scores within the
    repo's 0.5 pt PQ bar."""
    fresh = write_production_golden(tmp_path / "golden.npz")
    with np.load(PRODUCTION_GOLDEN) as g:
        for key in [f"budget_{f}" for f in BUDGET_FIELDS] + [
                "coarse_bits", "tight_bits", "feature_slots", "n_chunks"]:
            assert fresh[key] == g[key].item(), key
        assert [guardrail(str(m)) for m in fresh["warnings"]] == [
            guardrail(str(m)) for m in g["warnings"]]
        for key in MAP_KEYS:
            np.testing.assert_allclose(fresh[key], g[key], atol=1e-4)
        for key in ("pq_scene", "pq_masked", "sq", "rq"):
            assert abs(fresh[key] - float(g[key])) <= 0.005


@pytest.mark.slow
def test_options_golden_regenerates(tmp_path):
    """write_options_golden() reproduces the committed file: budgets,
    warnings and chunk counts equal, maps within 1e-4, scores within the
    repo's 0.5 pt PQ bar."""
    fresh = write_options_golden(tmp_path / "golden.npz")
    with np.load(OPTIONS_GOLDEN) as g:
        for name in OPTIONS:
            for key in [f"budget_{f}" for f in BUDGET_FIELDS] + ["n_chunks"]:
                assert fresh[f"{name}_{key}"] == g[f"{name}_{key}"].item()
            assert [guardrail(str(m)) for m in fresh[f"{name}_warnings"]] == [
                guardrail(str(m)) for m in g[f"{name}_warnings"]]
            for key in MAP_KEYS:
                np.testing.assert_allclose(fresh[f"{name}_{key}"],
                                           g[f"{name}_{key}"], atol=1e-4)
            for key in ("pq_scene", "pq_masked", "sq", "rq"):
                assert abs(fresh[f"{name}_{key}"]
                           - float(g[f"{name}_{key}"])) <= 0.005


def write_preprocess_golden(path=PREPROCESS_GOLDEN) -> dict:
    """The JAX package's ``preprocess_scannet`` and PanopLi reader on the
    raw ScanNet capture, with PIL as its codec (see the module docstring);
    the full scene and its 2-frame cut."""
    import hashlib
    import io
    import tempfile

    from PIL import Image

    from contrastive_lift_tpu.config import Config as JConfig
    from contrastive_lift_tpu.data import load_scene as j_load_scene
    from contrastive_lift_tpu.data.preprocessing.scannet import (
        preprocess_scannet as j_preprocess)
    from contrastive_lift_tpu_torch.inference import fidelity as fid

    def pil_encode(image, quality):
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, "JPEG", quality=quality)
        return buf.getvalue()

    def pil_pixels(data):
        return np.array(Image.open(io.BytesIO(data)))

    def j_load(tree):
        return j_load_scene(JConfig(dataset_class="panopli",
                                    dataset_root=str(tree),
                                    image_dim=fid.SCANNET_IMAGE_HW))

    out = {"seed": fid.SCANNET_SEED}
    with tempfile.TemporaryDirectory() as tmp:
        for prefix, n_frames, window in PREPROCESS_RECORDS:
            raw = fid.write_raw_scannet(Path(tmp) / f"{prefix}raw",
                                        n_frames=n_frames, encode=pil_encode)
            tree = Path(tmp) / f"{prefix}tree"
            j_preprocess(**fid.preprocess_kwargs(raw, tree, window))
            digests = fid.tree_digests(tree, pil_pixels)
            out.update({
                prefix + "sens_sha256": np.array(hashlib.sha256(
                    raw["sens"].read_bytes()).hexdigest()),
                prefix + "files": np.array(list(digests)),
                prefix + "digests": np.array(list(digests.values())),
                **{prefix + "reader_" + k: v for k, v in
                   fid.reader_record(j_load(tree)).items()}})
            out[prefix + "frames"] = n_frames
            out[prefix + "keyframe_window"] = window
    out.update(commit=_commit(), command=PREPROCESS_COMMAND)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def test_preprocess_golden_layout():
    """The committed preprocessing golden: both records, their trees'
    files (color, pose, labels, probabilities, splits, the pickle) with a
    digest each, the reader's 6 frames split 4 / 2 (cut: 1 / 1) with
    every field's digest and every 509th ray; under 1 MB."""
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    assert PREPROCESS_GOLDEN.stat().st_size < 1 << 20
    with np.load(PREPROCESS_GOLDEN) as g:
        assert int(g["seed"]) == fid.SCANNET_SEED
        for prefix, n_frames, window in PREPROCESS_RECORDS:
            assert int(g[prefix + "frames"]) == n_frames
            assert int(g[prefix + "keyframe_window"]) == window
            assert len(str(g[prefix + "sens_sha256"])) == 64
            files = list(g[prefix + "files"])
            assert len(files) == len(g[prefix + "digests"])
            kept = n_frames // window
            for sub, ext in (("color", "jpg"), ("pose", "txt"),
                             ("m2f_semantics", "png"), ("rs_instance", "png"),
                             ("m2f_probabilities", "npz"), ("depth", "png")):
                assert sum(f.startswith(sub + "/") and f.endswith(ext)
                           for f in files) == kept, sub
            assert {"splits.json", "segmentation_data.pkl",
                    "intrinsic/intrinsic_color.txt"} <= set(files)
            train = int(kept * 0.8)
            np.testing.assert_array_equal(g[prefix + "reader_splits"],
                                          [train, kept - train])
            assert g[prefix + "reader_digests"].shape == (
                kept, len(fid.READER_FIELDS))
            n_rays = -(-fid.SCANNET_IMAGE_HW[0] * fid.SCANNET_IMAGE_HW[1]
                       // fid.SCANNET_RAY_STRIDE)
            assert g[prefix + "reader_rays"].shape == (kept, n_rays, 8)
            assert np.isfinite(g[prefix + "reader_rays"]).all()
        assert len(str(g["commit"])) == 40
        assert str(g["command"]) == PREPROCESS_COMMAND


def _port_preprocess(tmp_path, prefix):
    """The port's part of the preprocessing phase on the CPU against the
    golden's ``prefix`` record: the raw capture (its ``.sens`` bytes), the
    tree and the reader."""
    import hashlib

    from contrastive_lift_tpu_torch.inference import fidelity as fid
    with np.load(PREPROCESS_GOLDEN) as g:
        golden = {k: g[k] for k in g.files}
    raw = fid.write_raw_scannet(tmp_path / "raw",
                                n_frames=int(golden[prefix + "frames"]))
    assert (hashlib.sha256(raw["sens"].read_bytes()).hexdigest()
            == str(golden[prefix + "sens_sha256"]))
    fid.run_preprocess(raw, tmp_path / "tree",
                       int(golden[prefix + "keyframe_window"]))
    scene = fid.load_preprocessed(tmp_path / "tree")
    res = fid.check_preprocess(tmp_path / "tree", golden, prefix, scene)
    assert res["files"] == len(golden[prefix + "files"])


def test_port_on_cpu_matches_preprocess_golden_cut(tmp_path):
    """The 2-frame cut at 968x1296 (an odd number of luma block rows, so the
    encoder's dummy block row) through the port on the CPU: the ``.sens``
    sha256, every file of the tree and the reader's arrays equal to the
    golden's. Then the card phase's training and render helpers on the
    tree, at a small grid and frame size: finite losses and maps."""
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    _port_preprocess(tmp_path, "cut_")
    overrides = dict(fid.PREPROCESS_OVERRIDES, min_grid_dim=16,
                     max_grid_dim=20, batch_size=256, chunk=512,
                     max_rays_instances=64, max_rays_segments=64)
    fit = fid.train_preprocessed(tmp_path / "tree", tmp_path / "run",
                                 overrides, device="cpu", train_hw=(12, 16))
    losses = [r for r in fit["records"] if "loss_main" in r]
    assert {"loss_clustering", "loss_segment"} <= set(losses[-1])
    assert all(np.isfinite(v) for r in losses for v in r.values()
               if isinstance(v, float))
    scene = fid.load_preprocessed(tmp_path / "tree", (24, 32))
    out = fid.render_preprocessed(fit["last"], fit["cfg"], scene,
                                  device="cpu", chunk=256)
    assert out["rays"] == 24 * 32
    assert all(np.isfinite(v).all() for m in out["maps"] for v in m.values())


@pytest.mark.slow
def test_port_on_cpu_matches_preprocess_golden(tmp_path):
    """The whole 12-frame capture through the port on the CPU (about a
    minute: 24 frames of 968x1296 decoded in Python)."""
    _port_preprocess(tmp_path, "")


def codec_files() -> dict:
    """The codec golden's files by kind, from one 480x640 frame with
    sensor-like noise: PIL's RGB-coded (``keep_rgb``), CMYK and
    progressive files (the last cut after 6 of its 10 scans, the luma's
    low AC bits still short), and the hand-written writers' YCCK (4:2:0
    chroma, full K), 4:4:0, 4:1:1, arithmetic (restarts and a DAC
    segment; sequential and progressive) and lossless (predictor 1,
    restarts every 16 rows, ids 1, 2, 3: RGB) files."""
    import io

    from PIL import Image
    from test_torch_port_codecs import (
        JFIF_APP0, _frame_image, _scan_cuts, _ycc_planes, adobe_app14,
        write_arithmetic_jpeg, write_huffman_jpeg, write_lossless_jpeg)
    from contrastive_lift_tpu_torch.inference import fidelity as fid

    rgb = _frame_image(*fid.CODEC_HW, seed=16, noise=2.0)
    ycc = _ycc_planes(rgb)

    def pil(image, **kw):
        buf = io.BytesIO()
        image.save(buf, "JPEG", quality=90, **kw)
        return buf.getvalue()

    progressive = pil(Image.fromarray(rgb), progressive=True)
    ycc_420 = [(2, 2), (1, 1), (1, 1)]
    return {
        "rgb_coded": pil(Image.fromarray(rgb), keep_rgb=True),
        "cmyk": pil(Image.fromarray(rgb).convert("CMYK")),
        "ycck": write_huffman_jpeg(
            ycc + [255 - rgb.min(axis=-1)], ycc_420 + [(2, 2)],
            markers=adobe_app14(2)),
        "sampling_440": write_huffman_jpeg(ycc, [(1, 2), (1, 1), (1, 1)],
                                           markers=JFIF_APP0),
        "sampling_411": write_huffman_jpeg(ycc, [(4, 1), (1, 1), (1, 1)],
                                           markers=JFIF_APP0),
        "progressive_smoothed": _scan_cuts(progressive)[5],
        "arithmetic": write_arithmetic_jpeg(
            ycc, ycc_420, markers=JFIF_APP0, restart=40,
            dac={"dc": (1, 3), "ac": 8}),
        "arithmetic_progressive": write_arithmetic_jpeg(
            ycc, ycc_420, markers=JFIF_APP0, progressive=True),
        "lossless": write_lossless_jpeg(list(np.moveaxis(rgb, -1, 0)), 1,
                                        restart_rows=16)}


def write_codec_golden(path=CODEC_GOLDEN) -> dict:
    """PIL's pixels of ``codec_files()`` and the JAX package's loads of two
    of them (see the module docstring)."""
    import tempfile

    import PIL
    from PIL import Image, features
    from test_torch_port_codecs import _pil_pixels

    from contrastive_lift_tpu.data.panopli import _load_rgb as j_load_rgb
    from contrastive_lift_tpu_torch.inference import fidelity as fid

    crop = (slice(0, fid.CODEC_CROP), slice(0, fid.CODEC_CROP))
    out = {"kinds": np.array(fid.CODEC_KINDS), "hw": np.array(fid.CODEC_HW),
           "load_hw": np.array(fid.CODEC_LOAD_HW),
           "pil": np.array(f"Pillow {PIL.__version__}, libjpeg-turbo "
                           f"{features.version('libjpeg_turbo')}")}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, data in codec_files().items():
            pixels = _pil_pixels(data)
            file = Path(tmp) / f"{kind}.jpg"
            file.write_bytes(data)
            out.update({f"{kind}_file": np.frombuffer(data, np.uint8),
                        f"{kind}_mode": np.array(Image.open(file).mode),
                        f"{kind}_shape": np.array(pixels.shape),
                        f"{kind}_digest": np.array(fid.array_digest(pixels)),
                        f"{kind}_crop": pixels[crop]})
            if kind in ("rgb_coded", "cmyk"):
                out[f"{kind}_load_rgb"] = j_load_rgb(file, fid.CODEC_LOAD_HW)
        grey = np.asarray(Image.open(Path(tmp) / "cmyk.jpg").convert("L"))
        out.update(cmyk_grey_digest=np.array(fid.array_digest(grey)),
                   cmyk_grey_crop=grey[crop])
    out.update(commit=_commit(), command=CODECS_COMMAND)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def test_codec_golden_layout_and_cpu_decode(tmp_path):
    """The committed codec golden: every kind at 480x640 with PIL's mode,
    shape, digest and corner, the two loads and the grey conversion;
    under 2 MB. Then the card phase's check on the CPU: every file
    decoded by the port equal to PIL's pixels, the loads and the grey
    conversion equal."""
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    assert CODEC_GOLDEN.stat().st_size < 2 << 20
    with np.load(CODEC_GOLDEN) as g:
        golden = {k: g[k] for k in g.files}
    assert tuple(golden["kinds"]) == fid.CODEC_KINDS
    assert tuple(golden["hw"]) == fid.CODEC_HW
    modes = {"cmyk": "CMYK", "ycck": "CMYK"}
    for kind in fid.CODEC_KINDS:
        assert golden[f"{kind}_file"][:2].tobytes() == b"\xff\xd8"
        assert str(golden[f"{kind}_mode"]) == modes.get(kind, "RGB")
        assert tuple(golden[f"{kind}_shape"]) == fid.CODEC_HW + (
            4 if kind in modes else 3,)
        assert golden[f"{kind}_crop"].shape[:2] == (fid.CODEC_CROP,) * 2
    for kind in ("rgb_coded", "cmyk"):
        assert golden[f"{kind}_load_rgb"].shape == fid.CODEC_LOAD_HW + (3,)
    assert len(str(golden["commit"])) == 40
    assert str(golden["command"]) == CODECS_COMMAND
    res = fid.check_codecs(golden, tmp_path, repeats=1)
    assert not res["failures"], res["failures"]
    assert set(res["decode_seconds"]) == set(fid.CODEC_KINDS)


if __name__ == "__main__":
    if sys.argv[1:] == ["codecs"]:
        rec = write_codec_golden()
        print({k: v for k, v in rec.items() if np.size(v) < 60})
    elif sys.argv[1:] == ["preprocess"]:
        rec = write_preprocess_golden()
        print({k: v for k, v in rec.items() if np.size(v) < 60})
    elif sys.argv[1:] == ["distilled"]:
        rec = write_distilled_golden()
        print({k: v for k, v in rec.items() if np.size(v) < 60})
    elif sys.argv[1:] == ["options"]:
        write_options_golden()
    elif sys.argv[1:] == ["tools"]:
        rec = write_tools_golden()
        print({k: v for k, v in rec.items() if np.size(v) < 60})
    elif sys.argv[1:] == ["cli"]:
        rec = write_cli_golden()
        print({k: v for k, v in rec.items() if k not in (
            "pred_semantics", "instance_features", "ray_index",
            "hdbscan_sample", "hdbscan_labels")})
    elif sys.argv[1:] == ["stage"]:
        rec = write_stage_golden()
        print({k: v for k, v in rec.items() if k != "sketches"})
    elif sys.argv[1:] == ["train"]:
        rec = write_train_step_golden()
        print({k: v for k, v in rec.items() if not k.startswith(("sketch_",
                                                                 "draw_"))})
    elif sys.argv[1:] == ["production"]:
        rec = write_production_golden()
        print({k: v for k, v in rec.items() if k not in MAP_KEYS
               and k != "ray_index"})
    else:
        rec = write_golden()
        print({k: rec[k] for k in ("pq_scene", "pq_masked", "sq", "rq",
                                   "n_samples", "commit", "jit_ray_index",
                                   "jit_max_abs_diff_rest", "jit_pq_scene",
                                   "jit_pq_masked")})
