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
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from contrastive_lift_tpu_torch.inference.fidelity import (  # noqa: E402
    BANDWIDTH, BUDGET_FIELDS, CHUNK, PRODUCTION_CHUNK, R5B_CKPT, R5B_SCENE,
    dense_config, guardrail, production_config)

GOLDEN = ROOT / "contrastive_lift_tpu_torch" / "testdata" / "r5b_dense_golden.npz"
PRODUCTION_GOLDEN = GOLDEN.with_name("r5b_production_golden.npz")
TRAIN_GOLDEN = GOLDEN.with_name("r5b_train_step_golden.npz")
RAY_STRIDE = 12
MAP_KEYS = ("rgb", "semantics", "instances", "depth")
# a golden ray counts as moved by jit where a map differs by more than this
JIT_ATOL = 1e-4
COMMAND = "JAX_PLATFORMS=cpu python tests/test_torch_port_golden.py"
PRODUCTION_COMMAND = COMMAND + " production"
TRAIN_COMMAND = COMMAND + " train"
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
    import warnings

    import jax
    jax.config.update("jax_platforms", "cpu")
    from contrastive_lift_tpu.inference import render as jrender
    from tools.pq_fidelity_gate import cluster_maps, e2e_config, e2e_scene, pq_for

    scene = e2e_scene(*R5B_SCENE)
    cfg = e2e_config(scene.image_dim)
    params, mcfg, rcfg, state_r, _ = jrender.load_model_for_inference(
        R5B_CKPT, cfg, scene.num_semantic_classes, step_ratio=0.25,
        head_topk=8)
    rcfg = production_config(rcfg)
    n_rays = sum(len(f.rays) for f in scene.val_frames)
    idx = np.arange(0, n_rays, RAY_STRIDE)
    calibrated, tails = [], []
    R = jrender.R
    real_calibrate, real_render_rays = R.calibrate_budgets, R.render_rays

    def calibrate_spy(mcfg, rcfg, state, probe, fused, **kw):
        out = real_calibrate(mcfg, rcfg, state, probe, fused, **kw)
        calibrated.append((out, fused))
        return out

    def render_rays_spy(*args, **kw):
        out = real_render_rays(*args, **kw)
        tails.append((float(out["budget_tail"]), float(out["head_tail"])))
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
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
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
        jit=False, commit=commit, command=PRODUCTION_COMMAND)
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
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from contrastive_lift_tpu.config import load_config
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
    from contrastive_lift_tpu_torch.inference.fidelity import R5B_CONFIG
    from contrastive_lift_tpu_torch.train.resume import TRAIN_METRICS, leaf_sketches
    from contrastive_lift_tpu_torch.utils.tree import (path_str,
                                                       tree_leaves_with_path)
    from tools.pq_fidelity_gate import e2e_scene
    from types import SimpleNamespace

    scene = e2e_scene(*R5B_SCENE)
    cfg = load_config(R5B_CONFIG)
    params, meta = load_checkpoint(R5B_CKPT)
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
    main_s = RayPoolSampler(frames, scene.num_semantic_classes)
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
    main_tx, inst_tx, _ = make_optimizers(cfg, params)

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
    leaves = [tree_leaves_with_path(t) for t in (params, grads, grads_i,
                                                 new_state.params)]
    out = {"leaf_paths": np.asarray([path_str(p) for p, _ in leaves[0]])}
    sketches = [leaf_sketches(i, *(np.asarray(t[i][1]) for t in leaves[1:]),
                              np.asarray(leaves[3][i][1])
                              - np.asarray(leaves[0][i][1]))
                for i in range(len(leaves[0]))]
    for j, name in enumerate(("grad_main", "grad_inst", "after", "delta")):
        out[f"sketch_{name}"] = np.stack([s[j] for s in sketches])
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    image_dim, num_train, checker_freq = R5B_SCENE
    out.update(
        {f"metric_{m}": float(metrics[m]) for m in TRAIN_METRICS},
        **draws, seed=TRAIN_SEED, aux_head_topk=k, epoch=epoch,
        global_step=global_step, lr_scale=lr_scale,
        lambda_dist_reg=lambda_dist, n_samples=rcfg.n_samples,
        image_dim=np.asarray(image_dim), num_train=num_train,
        checker_freq=checker_freq, jit=False, commit=commit,
        command=TRAIN_COMMAND)
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


if __name__ == "__main__":
    if sys.argv[1:] == ["train"]:
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
