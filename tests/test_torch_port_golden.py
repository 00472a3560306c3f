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
RAY_STRIDE = 12
MAP_KEYS = ("rgb", "semantics", "instances", "depth")
# a golden ray counts as moved by jit where a map differs by more than this
JIT_ATOL = 1e-4
COMMAND = "JAX_PLATFORMS=cpu python tests/test_torch_port_golden.py"
PRODUCTION_COMMAND = COMMAND + " production"


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
    if sys.argv[1:] == ["production"]:
        rec = write_production_golden()
        print({k: v for k, v in rec.items() if k not in MAP_KEYS
               and k != "ray_index"})
    else:
        rec = write_golden()
        print({k: rec[k] for k in ("pq_scene", "pq_masked", "sq", "rq",
                                   "n_samples", "commit", "jit_ray_index",
                                   "jit_max_abs_diff_rest", "jit_pq_scene",
                                   "jit_pq_masked")})
