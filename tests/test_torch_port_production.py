"""The modules of the port's production render path against the JAX
package, on the CPU at grid 14: occupancy tables, L2-only selection, fine
density with two-phase termination, calibrated budgets, and top-k heads (one
pass and two phases) with tail completion.

The fields are grid-14 checkpoints saved with the JAX package:
``_sparse_checkpoint``'s is empty (below the occupancy threshold) outside an
opaque disk-shaped slab, so rays skip empty space, hit the slab or miss it;
``test_torch_port_render.py::_checkpoint``'s is low and high density
everywhere above the occupancy threshold, so every block is occupied. The JAX
functions below the frame loop run eagerly, so tables, selections and budgets
compare with ``array_equal``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from contrastive_lift_tpu.factory import build_model
from contrastive_lift_tpu.inference import render as jrender
from contrastive_lift_tpu.io.checkpoint import save_checkpoint
from contrastive_lift_tpu.ops import fused_grid as jfg
from contrastive_lift_tpu.renderer import render as jR
from contrastive_lift_tpu_torch.inference import render as trender
from contrastive_lift_tpu_torch.ops import fused_grid as tfg
from contrastive_lift_tpu_torch.renderer import render as tR
from test_torch_port_render import (BBOX, MAP_KEYS, VARIANTS, JConfig,
                                    TConfig, _cfg, _checkpoint, _rays)

torch.set_num_threads(2)
F32_BAR = dict(atol=2e-5, rtol=1e-4)
# the bar the JAX package accepts for bf16 against fp32 heads
BF16_BAR = dict(atol=3e-2, rtol=0)


def _sparse_checkpoint(path, cfg_kw, bbox=BBOX, classes=2):
    """A grid-14 field whose raw density is about -8 (empty) everywhere but
    in a slab 3 voxels deep across a disk of radius 5.5 voxels, where it is
    about 22 (opaque)."""
    mcfg, params, _, _ = build_model(_cfg(JConfig, **cfg_kw), classes, bbox,
                                     (14, 14, 14), step_ratio=0.25)
    params = jax.tree.map(np.array, params)
    planes = [p * 2 for p in params["density"]["planes"]]
    lines = list(params["density"]["lines"])
    y, x = np.meshgrid(np.arange(14), np.arange(14), indexing="ij")
    planes[0][0] = ((y - 6.5) ** 2 + (x - 6.0) ** 2 < 30).astype(np.float32)
    lines[0][0] = np.where((np.arange(14) >= 6) & (np.arange(14) <= 8),
                           30.0, 0.0)
    planes[0][1], lines[0][1] = 1.0, -8.0
    params["density"] = {"planes": tuple(planes), "lines": tuple(lines)}
    save_checkpoint(path, params, grid_dim=(14, 14, 14), bbox_aabb=bbox,
                    epoch=0, global_step=0)
    return path


def _load(ckpt, kw=None, step_ratio=0.25):
    """(JAX model, port model): (params, mcfg, rcfg, state) of ``ckpt``
    with the production defaults (head_topk "auto")."""
    kw = kw or {}
    j = jrender.load_model_for_inference(ckpt, _cfg(JConfig, **kw), 2,
                                         step_ratio=step_ratio)[:4]
    t = trender.load_model_for_inference(ckpt, _cfg(TConfig, **kw), 2,
                                         step_ratio=step_ratio,
                                         device="cpu")[:4]
    return j, t


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    """The grid-14 field, both models, their compact grids and the L2-only
    grouped configs that render_frames derives before calibrating."""
    ckpt = _sparse_checkpoint(tmp_path_factory.mktemp("field") / "field.npz",
                              {})
    (jp, jm, jr, js), (tp, tm, tr, ts) = _load(ckpt)
    jr = jR.occ_grouping_for(dataclasses.replace(jr, use_l1=False), js)
    tr = tR.occ_grouping_for(dataclasses.replace(tr, use_l1=False), ts)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tr.l2_flat_group >= 2
    jf = jfg.build_render_grids(jp, jm, jr, js, compact=True,
                                feature_dtype=jnp.float32)
    tf = tfg.build_render_grids(tp, tm, tr, ts, compact=True,
                                feature_dtype="float32")
    return dict(ckpt=ckpt, j=(jp, jm, jr, js, jf), t=(tp, tm, tr, ts, tf))


@pytest.mark.parametrize("step_ratio", [0.25, 0.5])
def test_occupancy_tables_match_jax(tmp_path, step_ratio):
    """coarse (dilated) and tight maxima, both bit tables and the slot map
    are the JAX package's, at the inference step and at the training step
    (whose tight window is wider)."""
    ckpt = _sparse_checkpoint(tmp_path / "field.npz", {})
    (jp, jm, jr, js), (tp, tm, tr, ts) = _load(ckpt, step_ratio=step_ratio)
    jf = jfg.build_render_grids(jp, jm, jr, js, compact=True,
                                feature_dtype=jnp.float32)
    tf = tfg.build_render_grids(tp, tm, tr, ts, compact=True,
                                feature_dtype="float32")
    assert tf.coarse_dim == tuple(jf.coarse_dim)
    assert not np.asarray(jf.occ_bits_group)[:, 4:].any()
    for name, want, got in (
            ("coarse_occ", jf.coarse_occ[:, 0], tf.coarse_occ),
            ("coarse_occ_tight", jf.coarse_occ_tight[:, 0], tf.coarse_occ_tight),
            ("occ_bits_group", jf.occ_bits_group[:, :4], tf.occ_bits_group),
            ("occ_bits_group_tight", jf.occ_bits_group_tight[:, :4],
             tf.occ_bits_group_tight),
            ("slot_map", jf.slot_map[:, 0], tf.slot_map),
            ("brick_atlas", jf.brick_atlas, tf.brick_atlas)):
        got = got.numpy()
        np.testing.assert_array_equal(got, np.asarray(want).astype(got.dtype),
                                      err_msg=name)
    # the field has empty blocks and occupied ones
    slots = tf.slot_map.numpy()
    assert 0 < np.count_nonzero(slots) < slots.size
    tight = tf.coarse_occ_tight.numpy()
    thres = tfg.raw_occupancy_threshold(tm.splus_density_shift,
                                        float(ts.step_size), tr.distance_scale,
                                        tr.occ_alpha_thres)
    assert 0 < np.mean(tight > thres) < 1


def test_compact_features_match_jax(field):
    """The features the heads read through the slot map equal the JAX
    compact table's at fp32 summation-order tolerance, zero in blocks
    without a slot, on samples over the whole box and beyond it."""
    _, _, _, _, jf = field["j"]
    _, _, _, _, tf = field["t"]
    xyz = np.random.default_rng(3).uniform(-1.05, 1.05, (4000, 3)).astype(
        np.float32)
    want = np.asarray(jfg.sample_feature_fused(jf, "appearance",
                                               jnp.asarray(xyz), out_dim=27))
    got = tfg.sample_feature_fused(tf, "appearance", torch.from_numpy(xyz))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    empty = (want == 0).all(axis=1)
    assert 0 < empty.sum() < len(xyz)
    assert (got.numpy()[empty] == 0).all()


@pytest.mark.parametrize("variant", ["e2e", "grid_heads"])
def test_bf16_feature_grids_match_jax(tmp_path, variant):
    """With bf16 heads the feature grids are rounded to bf16, as the JAX
    package's are. Both round their float32 grid to nearest even; the float32
    grids themselves differ in the last bits (the basis contraction sums in
    another order), so a value that lies within those bits of a bf16
    rounding boundary rounds one bf16 step apart. Everywhere else the bf16
    grids are equal."""
    ckpt = _checkpoint(tmp_path / "field.npz", VARIANTS[variant])
    (jp, jm, jr, js), (tp, tm, tr, ts) = _load(ckpt, VARIANTS[variant])
    jf = jfg.build_render_grids(jp, jm, jr, js, compact=False,
                                feature_dtype=jnp.bfloat16)
    tf = tfg.build_render_grids(tp, tm, tr, ts, compact=False,
                                feature_dtype="bfloat16")
    names = [n for n in ("appearance", "semantic", "instance") if n in tp]
    assert sorted(tf.features) == sorted(names)
    for name in names:
        got = tf.features[name]
        assert got.dtype == torch.bfloat16
        want_f32 = np.asarray(jfg.build_dense_feature(jp, name))
        got_f32 = tfg.build_dense_feature(tp, name).numpy()
        np.testing.assert_allclose(got_f32, want_f32, atol=1e-7, rtol=1e-6)
        table = (jf.feature_cells["appearance"] if name == "appearance"
                 else jf.feature_cells["semantic+instance"])
        assert table.dtype == jnp.bfloat16
        want = np.asarray(jfg.build_dense_feature(jp, name, jnp.bfloat16)
                          .astype(jnp.float32))
        got = got.float().numpy()
        differ = got != want
        assert differ.mean() < 1e-3
        # only where the float32 grids differ, by one bf16 step
        assert (want_f32[differ] != got_f32[differ]).all()
        step = np.abs(want[differ]) * 2.0 ** -7
        assert (np.abs(got[differ] - want[differ]) <= step * 1.01).all()


def _shell_rays(n, seed, lo=-1.3, hi=1.3):
    """Rays of consecutive occupancy tests: [n, 64, 3] normalized positions,
    starting anywhere in [lo, hi]^3 (outside the box too, where the
    truncation toward zero matters), advancing at most 0.4 voxels a test."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 1, 3))
    d = rng.normal(size=(n, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    steps = np.arange(64)[None, :, None] * 0.06 * rng.uniform(0.1, 1.0, (n, 1, 1))
    return (o + d * steps).astype(np.float32)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), group=st.sampled_from([2, 4, 8]),
       p_occ=st.floats(0.02, 0.98),
       grid=st.sampled_from([(14, 14, 14), (13, 17, 10), (21, 9, 16)]))
def test_grouped_bit_tests_match_jax(seed, group, p_occ, grid):
    """sample_occ_bits_grouped and sample_coarse_occ on random occupancy
    (random block maxima, thresholded) equal the JAX package's."""
    rng = np.random.default_rng(seed)
    cdim = tuple(-(-g // 4) for g in grid)
    vals = {tight: rng.uniform(-1, 1, cdim).astype(np.float32)
            for tight in (False, True)}
    thres = float(np.quantile(vals[False], 1 - p_occ))
    tables = {}
    for tight, v in vals.items():
        bits = v > thres
        tables[tight] = (jfg._pack_neighborhood_bits(jnp.asarray(bits)),
                         tfg._pack_neighborhood_bits(torch.from_numpy(bits)))
    jfused = jfg.FusedGrids(None, grid, {}, coarse_dim=cdim,
                            coarse_occ=jnp.repeat(jnp.asarray(
                                vals[False]).reshape(-1, 1), 8, axis=1),
                            coarse_occ_tight=jnp.repeat(jnp.asarray(
                                vals[True]).reshape(-1, 1), 8, axis=1),
                            occ_bits_group=tables[False][0],
                            occ_bits_group_tight=tables[True][0])
    tfused = tfg.FusedGrids(grid, None, {}, coarse_dim=cdim,
                            coarse_occ=torch.from_numpy(vals[False]).reshape(-1),
                            coarse_occ_tight=torch.from_numpy(
                                vals[True]).reshape(-1),
                            occ_bits_group=tables[False][1],
                            occ_bits_group_tight=tables[True][1])
    xyz = _shell_rays(12, seed)
    for tight in (False, True):
        want = np.asarray(jfg.sample_occ_bits_grouped(
            jfused, jnp.asarray(xyz), group, tight=tight))
        got = tfg.sample_occ_bits_grouped(tfused, torch.from_numpy(xyz),
                                          group, tight=tight).numpy()
        np.testing.assert_array_equal(got, want)
        flat = xyz.reshape(-1, 3)
        np.testing.assert_array_equal(
            tfg.sample_coarse_occ(tfused, torch.from_numpy(flat),
                                  tight=tight).numpy(),
            np.asarray(jfg.sample_coarse_occ(jfused, jnp.asarray(flat),
                                             tight=tight)))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), rows=st.integers(1, 6),
       cols=st.integers(1, 40), k=st.integers(1, 48),
       p=st.floats(0.0, 1.0))
def test_first_k_set_matches_jax(seed, rows, cols, k, p):
    mask = np.random.default_rng(seed).random((rows, cols)) < p
    want = jR._first_k_set(jnp.asarray(mask), k)
    got = tR._first_k_set(torch.from_numpy(mask), k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _both_rays(n, seed):
    rays = _rays(n, seed)
    # a few rays that start inside the box, and one that misses it
    rays[:8, 0:3] = np.random.default_rng(seed).uniform(-0.5, 0.5, (8, 3))
    rays[8, 0:3] = (5.0, 5.0, -2.0)
    return rays


@pytest.mark.parametrize("grouped", [True, False])
def test_select_subsegments_matches_jax(field, grouped):
    """The L2-flat selection (fine steps, validity, occupied counts) equals
    the JAX package's, with grouped bit tests and with the ungrouped
    fallback (l2_flat_group 0) that thresholds the raw tight maxima."""
    jp, jm, jr, js, jf = field["j"]
    tp, tm, tr, ts, tf = field["t"]
    if not grouped:
        jr = dataclasses.replace(jr, l2_flat_group=0)
        tr = dataclasses.replace(tr, l2_flat_group=0)
    rays = _both_rays(300, 4)
    jo, jd, jt = jR._ray_tmin(js, jnp.asarray(rays))
    want = jR._select_subsegments(jm, jr, js, jo, jd, jt, jf, None, None)
    got = tR._select_subsegments(tm, tr, ts,
                                 *tR._ray_tmin(ts, torch.from_numpy(rays)), tf)
    for name, w, g in zip(("fine_steps", "sample_valid", "needed"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    needed = got[2].numpy()
    assert needed.min() == 0 and 0 < np.median(needed) < -(-tr.n_samples // 8)


# termination survivor fractions: None = a single pass; "ties" = every ray
# with samples left survives and the cut falls among the rays without any
# (which all tie at -1); 0.25 = fewer slots than rays with samples left
@pytest.mark.parametrize("fraction", [None, "ties", 0.25])
def test_two_level_density_matches_jax(field, fraction):
    """Fine density, in one pass and with early termination: the samples,
    their weights (within 1e-5) and the survivors are the JAX package's.
    Where the cut falls among rays that tie at -1, the survivors are the
    same rays (both sorts are stable). Where it falls among residuals, the
    survivors' residuals agree within float32 rounding: residuals that
    differ only by it (on this field, rays whose pass A saw nothing but empty
    space keep a residual of 1 up to the last bit) may order differently."""
    jp, jm, jr, js, jf = field["j"]
    tp, tm, tr, ts, tf = field["t"]
    rays = torch.from_numpy(_both_rays(256, 5))
    kA, sub = 4, tr.sub_stride
    _, valid, _ = tR._select_subsegments(tm, tr, ts, *tR._ray_tmin(ts, rays),
                                         tf)
    with_tail = int(valid[:, kA:].flatten(1).any(1).sum())
    if fraction == "ties":
        fraction = (with_tail + 8) / len(rays)
    kw = dict(max_subsegments=8, term_first=kA if fraction else 0,
              term_fraction=fraction or 0.25)
    jr, tr = dataclasses.replace(jr, **kw), dataclasses.replace(tr, **kw)
    want = jR._two_level_density(jm, jr, js, jnp.asarray(rays.numpy()), jf)
    got = tR._two_level_density(tm, tr, ts, rays, tf)
    names = ("xyz_n", "z_vals", "in_box", "dists", "mids", "alpha", "weight",
             "bg_weight", "budget_tail")
    for name, w, g in zip(names, want, got):
        assert g.shape == np.shape(w), name
    assert float(np.asarray(want[6]).sum(-1).max()) > 0.5
    if not fraction:
        for name, w, g in zip(names, want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0, err_msg=name)
        return
    # pass B's rows are zero for the rays that stopped after pass A
    cols = slice(kA * sub, None)
    survived = [(np.asarray(z)[:, cols] != 0).any(axis=1)
                for z in (want[1], got[1].numpy())]
    n_s = round(len(rays) * fraction)
    assert survived[1].sum() == survived[0].sum() == n_s
    if n_s > with_tail:
        np.testing.assert_array_equal(survived[1], survived[0])
        for name, w, g in zip(names, want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0, err_msg=name)
        return
    # residual after pass A: the weight a survivor's pass B could add
    residual = [np.asarray(out[7])[:, 0] + np.asarray(out[6])[:, cols].sum(1)
                for out in (want, got)]
    np.testing.assert_allclose(np.sort(residual[1][survived[1]]),
                               np.sort(residual[0][survived[0]]), rtol=1e-6)
    same = survived[0] == survived[1]
    assert same.mean() > 0.95
    for i in (1, 6):
        np.testing.assert_allclose(got[i].numpy()[same],
                                   np.asarray(want[i])[same], atol=1e-5,
                                   rtol=0, err_msg=names[i])


@pytest.mark.parametrize("termination,tail_eps", [(True, 0.0), (False, 0.0),
                                                  (True, 1e-3)])
def test_calibrated_budgets_match_jax(field, termination, tail_eps):
    """calibrate_budgets on a probe gives the JAX package's RenderConfig,
    field by field."""
    jp, jm, jr, js, jf = field["j"]
    tp, tm, tr, ts, tf = field["t"]
    probe = _both_rays(400, 6)
    kw = dict(termination=termination, tail_eps=tail_eps, head_term=True)
    want = jR.calibrate_budgets(jm, jr, js, jnp.asarray(probe), jf, **kw)
    got = tR.calibrate_budgets(tm, tr, ts, probe, tf, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if termination:
        assert 0 < got.term_first < got.max_subsegments


def _sharp_shell(grid_dim, bbox, center):
    """A thin opaque spherical shell (radius 0.45) around ``center``, as a
    pre-activation density grid."""
    axes = [np.linspace(bbox[0][a], bbox[1][a], g) for a, g in enumerate(grid_dim)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt((X - center[0])**2 + (Y - center[1])**2 + (Z - center[2])**2)
    return np.where(np.abs(r - 0.45) < 0.07, 60.0, 0.0).astype(np.float32)


def test_head_term_calibrated_and_rendered_like_jax(field):
    """On a sharp surface the JAX package's calibration picks two-phase heads
    (head_term_first > 0); the port picks the same config, and renders with
    it as the JAX package does (fp32 heads)."""
    jp, jm, jr, js, _ = field["j"]
    tp, tm, tr, ts, _ = field["t"]
    bbox = np.asarray(js.bbox_aabb)
    center = bbox.mean(axis=0)
    dense = _sharp_shell((14, 14, 14), bbox, center)
    jf = jfg.build_render_grids(jp, jm, jr, js, compact=True,
                                feature_dtype=jnp.float32,
                                dense_override=jnp.asarray(dense))
    tf = tfg.build_render_grids(tp, tm, tr, ts, compact=True,
                                feature_dtype="float32",
                                dense_override=torch.from_numpy(dense))
    rng = np.random.default_rng(13)
    o = center + rng.uniform(-0.1, 0.1, (256, 3))
    d = rng.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((256, 1), 0.01),
                           np.full((256, 1), 1.5)], -1).astype(np.float32)
    kw = dict(termination=True, head_term=True)
    want = jR.calibrate_budgets(jm, jr, js, jnp.asarray(rays), jf, **kw)
    got = tR.calibrate_budgets(tm, tr, ts, rays, tf, **kw)
    assert want.head_term_first > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for complete in (False, True):
        jc = dataclasses.replace(want, head_tail_complete=complete)
        tc = dataclasses.replace(got, head_tail_complete=complete)
        j_out = jR.render_rays(jp, jm, jc, js, jnp.asarray(rays), None, False,
                               fused=jf)
        t_out = tR.render_rays(tp, tm, tc, ts, torch.from_numpy(rays),
                               fused=tf)
        for key in MAP_KEYS + ("opacity", "budget_tail", "head_tail"):
            np.testing.assert_allclose(t_out[key].numpy(),
                                       np.asarray(j_out[key]), **F32_BAR,
                                       err_msg=f"{key}, complete={complete}")


def test_unported_production_options_raise(field):
    """Heavy/light bucketing, which the port once refused, renders as the
    JAX package's render_rays. The L1 segment cascade (use_l1=True, with
    sub-segments or coarse segments only) renders as JAX's, and its budget
    calibration, once refused too, gives the JAX package's config. No
    option of the production path raises NotImplementedError any more."""
    jp, jm, jr, js, jf = field["j"]
    tp, tm, tr, ts, tf = field["t"]
    rays = _rays(64, 0)
    light = dict(max_subsegments=8, max_subsegments_light=4, term_first=0)
    want = jR.render_rays(jp, jm, dataclasses.replace(jr, **light), js,
                          jnp.asarray(rays), None, False, fused=jf)
    got = tR.render_rays(tp, tm, dataclasses.replace(tr, **light), ts,
                         torch.from_numpy(rays), fused=tf)
    for key in MAP_KEYS + ("budget_tail",):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **F32_BAR, err_msg=f"{key}, heavy/light")
    for changes, name in ((dict(use_l1=True), "use_l1"),
                          (dict(sub_stride=None, use_l1=True), "sub_stride"),
                          (dict(sub_stride=16), "sub_stride")):
        rc = dataclasses.replace(tr, **changes)
        jrc = dataclasses.replace(jr, **changes)
        want = jR.render_rays(jp, jm, jrc, js, jnp.asarray(rays), None, False,
                              fused=jf)
        got = tR.render_rays(tp, tm, rc, ts, torch.from_numpy(rays), fused=tf)
        for key in MAP_KEYS + ("budget_tail",):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       **F32_BAR, err_msg=f"{key}, {changes}")
        assert dataclasses.asdict(tR.calibrate_budgets(tm, rc, ts, rays, tf)) \
            == dataclasses.asdict(jR.calibrate_budgets(jm, jrc, js,
                                                       jnp.asarray(rays), jf)), \
            name
