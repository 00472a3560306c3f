"""The port's opt-in render options against the JAX package, on the CPU at
grid 14: the L1 segment budget and heavy/light bucketing of the
calibration, the heavy/light fine density, iter and rank head selection
(render and training's aux passes), the unique-cell dedup of the head
feature reads, the span form of the density kernel (its plain version) with
``validate_fine_span``, baked heads, and each option of
``inference/fidelity.py::OPTIONS`` through ``render_frames`` and the render
CLI (``--l1``, ``--no-term``).

The field is ``_fog_checkpoint``'s: ``test_torch_port_production.py``'s
sparse field with its opaque slab thickened into a semi-transparent fog 10
voxels deep, so that some rays need many sub-segments and others few (the
calibration then picks a light budget). The same numpy inputs go through
both packages. Budgets, indices and selections compare with
``array_equal``, fp32 maps at the fp32 summation-order bar ``F32_BAR``,
baked heads at the bf16 bar of 3e-2.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastive_lift_tpu.cli import evaluate as j_eval_cli
from contrastive_lift_tpu.cli import render as j_render_cli
from contrastive_lift_tpu.inference import render as jrender
from contrastive_lift_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from contrastive_lift_tpu.ops import fused_grid as jfg
from contrastive_lift_tpu.renderer import render as jR
from contrastive_lift_tpu.renderer.bake import bake_head_tables as j_bake
from contrastive_lift_tpu_torch.cli import evaluate as t_eval_cli
from contrastive_lift_tpu_torch.cli import render as t_render_cli
from contrastive_lift_tpu_torch.inference import render as trender
from contrastive_lift_tpu_torch.inference.fidelity import OPTIONS
from contrastive_lift_tpu_torch.models import tensorf as ttf
from contrastive_lift_tpu_torch.ops import brick_interp as bi
from contrastive_lift_tpu_torch.ops import fused_grid as tfg
from contrastive_lift_tpu_torch.renderer import bake as tbake
from contrastive_lift_tpu_torch.renderer import render as tR
from test_torch_port_cli import SCENE_HW, _assert_trees_match, cli_run  # noqa: F401
from test_torch_port_production import (BF16_BAR, F32_BAR, _both_rays, _load,
                                        _sparse_checkpoint)
from test_torch_port_render import MAP_KEYS, JFrame, TFrame, _rays

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")
MODES = ("sort", "iter", "rank")
THRES = 1e-4


def _fog_checkpoint(path):
    """``_sparse_checkpoint``'s disk with raw density about 7 over voxels
    2-11 along z (alpha about 0.04 a sample) in empty space."""
    _sparse_checkpoint(path, {})
    params, meta = load_checkpoint(path)
    lines = list(params["density"]["lines"])
    lines[0][0] = np.where((np.arange(14) >= 2) & (np.arange(14) <= 11),
                           15.0, 0.0).astype(np.float32)
    params["density"]["lines"] = tuple(lines)
    save_checkpoint(path, params, grid_dim=(14, 14, 14),
                    bbox_aabb=np.asarray(meta["bbox_aabb"]), epoch=0,
                    global_step=0)
    return path


def _grids(ckpt, kw=None):
    """Both models of ``ckpt`` with the L2-only grouped config that
    render_frames derives, and their compact float32 grids."""
    (jp, jm, jr, js), (tp, tm, tr, ts) = _load(ckpt, kw)
    jr = jR.occ_grouping_for(dataclasses.replace(jr, use_l1=False), js)
    tr = tR.occ_grouping_for(dataclasses.replace(tr, use_l1=False), ts)
    jf = jfg.build_render_grids(jp, jm, jr, js, compact=True,
                                feature_dtype=jnp.float32)
    tf = tfg.build_render_grids(tp, tm, tr, ts, compact=True,
                                feature_dtype="float32")
    return (jp, jm, jr, js, jf), (tp, tm, tr, ts, tf)


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    ckpt = _fog_checkpoint(tmp_path_factory.mktemp("field") / "f.npz")
    j, t = _grids(ckpt)
    return dict(ckpt=ckpt, j=j, t=t)


@pytest.fixture(scope="module")
def slab(tmp_path_factory):
    """The sparse field itself: behind its opaque slab a ray's live samples
    fall in few cells, so 7 unique-cell runs cover every ray."""
    ckpt = _sparse_checkpoint(tmp_path_factory.mktemp("slab") / "s.npz", {})
    j, t = _grids(ckpt)
    return dict(ckpt=ckpt, j=j, t=t)


# calibrate_budgets cases: RenderConfig changes, keywords
BUDGET_CASES = {
    "l1": (dict(use_l1=True), dict(termination=True)),
    "l1_light": (dict(use_l1=True), dict(termination=False)),
    "l1_bounded": (dict(use_l1=True), dict(termination=True, tail_eps=1e-3)),
    "l1_segments_only": (dict(use_l1=True, sub_stride=None),
                         dict(termination=True)),
    "l2_light": ({}, dict(termination=False)),
    "l2_light_rank": (dict(head_select="rank"),
                      dict(termination=False, head_term=True)),
}


@pytest.mark.parametrize("case", sorted(BUDGET_CASES))
def test_calibrated_budgets_match_jax(field, case):
    """calibrate_budgets with the L1 segment budget and with the heavy/light
    light budget (termination off) gives the JAX package's RenderConfig,
    field by field."""
    jp, jm, jr, js, jf = field["j"]
    tp, tm, tr, ts, tf = field["t"]
    changes, kw = BUDGET_CASES[case]
    probe = _both_rays(400, 6)
    want = jR.calibrate_budgets(jm, dataclasses.replace(jr, **changes), js,
                                jnp.asarray(probe), jf, **kw)
    got = tR.calibrate_budgets(tm, dataclasses.replace(tr, **changes), ts,
                               probe, tf, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if not kw["termination"] and got.sub_stride is not None:
        assert 0 < got.max_subsegments_light < got.max_subsegments


def test_heavy_light_density_matches_jax(field):
    """The two-pass heavy/light fine density: light rays (by occupied
    count, stable order) at the light budget, padded to the full width,
    heavy rays at the full budget, back in ray order; samples, weights and
    budget_tail as the JAX package's."""
    jp, jm, jr, js, jf = field["j"]
    tp, tm, tr, ts, tf = field["t"]
    rays = torch.from_numpy(_both_rays(256, 5))
    kw = dict(max_subsegments=8, max_subsegments_light=3, heavy_fraction=0.25,
              term_first=0)
    want = jR._two_level_density(jm, dataclasses.replace(jr, **kw), js,
                                 jnp.asarray(rays.numpy()), jf)
    got = tR._two_level_density(tm, dataclasses.replace(tr, **kw), ts, rays,
                                tf)
    names = ("xyz_n", "z_vals", "in_box", "dists", "mids", "alpha", "weight",
             "bg_weight", "budget_tail")
    for name, w, g in zip(names, want, got):
        assert g.shape == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_BAR,
                                   err_msg=name)
    # light rays carry zero columns past the light budget; heavy ones do not
    sub = tr.sub_stride
    tail_cols = got[1][:, 3 * sub:] != 0
    assert 0 < int(tail_cols.any(1).sum()) <= round(256 * 0.25)
    assert float(np.asarray(want[6]).sum(-1).max()) > 0.5


def _weights(seed, rows=64, cols=40):
    """Compositing-like weights with ties: exact zeros, repeated values and
    values on both sides of the head threshold."""
    rng = np.random.default_rng(seed)
    w = rng.choice(np.float32([0.0, 0.0, 5e-5, 0.02, 0.1, 0.1]), (rows, cols))
    w = w + (rng.random((rows, cols)) < 0.3) * rng.random((rows, cols)) * 0.2
    return w.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_iter_matches_sort_and_lax_top_k(seed):
    """k argmax passes give lax.top_k's values and indices (ties lowest
    index first), and those of the port's stable sort."""
    w = _weights(seed)
    for k in (1, 8, 39):
        vals, idx = tR._topk_iter(torch.from_numpy(w), k)
        want_v, want_i = jax.lax.top_k(jnp.asarray(w), k)
        j_iter = jR._topk_iter(jnp.asarray(w), k)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_iter[1]))
        srt = torch.sort(torch.from_numpy(w), dim=1, descending=True,
                         stable=True)
        np.testing.assert_array_equal(idx.numpy(), srt.indices[:, :k].numpy())


@pytest.mark.parametrize("weight_mode", ["softmax", "argmax"])
@pytest.mark.parametrize("mode", MODES)
def test_head_select_matches_jax(mode, weight_mode):
    """_head_select in each mode (rank falls back to sort under argmax
    weights): indices and kept weights equal to the JAX package's,
    head_tail within F32_BAR; _aux_topk in the same mode keeps the same
    samples and reports the same guardrail."""
    w = _weights(2)
    rc = dict(n_samples=40, num_semantic_classes=2, dim_feature_instance=6,
              head_topk=8, head_select=mode, semantic_weight_mode=weight_mode,
              raymarch_weight_thres=THRES)
    jr, tr = jR.RenderConfig(**rc), tR.RenderConfig(**rc)
    assert tR._head_select_mode(tr) == jR._head_select_mode(jr)
    want = jR._head_select(jr, jnp.asarray(w), 8)
    got = tR._head_select(tr, torch.from_numpy(w), 8)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(float(got[2]), float(want[2]), **F32_BAR)
    if tR._head_select_mode(tr) == "rank":
        assert float(got[2]) > 0.0  # rays drop above-threshold mass
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-1, 1, w.shape + (3,)).astype(np.float32)
    z = np.sort(rng.uniform(0, 4, w.shape), axis=1).astype(np.float32)
    live = np.arange(len(w)) % 5 != 0
    want = jR._aux_topk(jr, jnp.asarray(w), jnp.asarray(xyz), jnp.asarray(z),
                        jnp.asarray(live))
    got = tR._aux_topk(tr, torch.from_numpy(w), torch.from_numpy(xyz),
                       torch.from_numpy(z), torch.from_numpy(live))
    for name, a, b in zip(("w_k", "xyz_k", "z_k", "tail"), want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def _head_inputs(field, n=256, seed=7):
    """(port, JAX) inputs of the head dedup: the fine samples and weights
    of the port's one-pass density, the live mask and the top-8 indices."""
    tp, tm, tr, ts, tf = field["t"]
    rays = torch.from_numpy(_both_rays(n, seed))
    out = tR._two_level_density(tm, dataclasses.replace(tr, term_first=0),
                                ts, rays, tf)
    xyz_n, weight = out[0], out[6]
    live = weight > THRES
    _, idx, _ = tR._head_select(tr, weight, 8)
    xyz_k = torch.gather(xyz_n, 1, idx[..., None].expand(*idx.shape, 3))
    return (xyz_n, live, idx, xyz_k), tuple(
        jnp.asarray(t.numpy()) for t in (xyz_n, live, idx, xyz_k))


@pytest.mark.parametrize("cap", [2, 7])
def test_head_dedup_matches_jax(slab, cap):
    """Unique-cell slots, run keys, run counts and the overflow tail equal
    to the JAX package's; the deduplicated features within F32_BAR of the
    JAX compact table's, and where no run overflowed equal bit for bit to
    the port's per-sample reads."""
    jf, tf = slab["j"][4], slab["t"][4]
    (xyz_n, live, idx, xyz_k), (jx, jl, ji, jxk) = _head_inputs(slab)
    want = jfg.head_dedup_slots(jf, jx, jl, cap)
    got = tfg.head_dedup_slots(tf, xyz_n, live, cap)
    for name, a, b in zip(("slot", "uid", "tail"), want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    runs = tfg.head_dedup_run_counts(tf, xyz_n, live)
    np.testing.assert_array_equal(
        runs.numpy(), np.asarray(jfg.head_dedup_run_counts(jf, jx, jl)))
    assert int(runs.max()) > 2
    slot_k = torch.gather(got[0], 1, idx)
    feats = tfg.sample_feature_dedup(tf, "appearance", got[1], slot_k, xyz_k)
    want_f = jfg.sample_feature_dedup(
        jf, "appearance", want[1], jnp.take_along_axis(want[0], ji, axis=1),
        jxk, 27)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_f), **F32_BAR)
    if cap == 2:
        assert float(got[2]) > 0
    else:
        # samples below the threshold share the slot of the run before
        # them; the heads mask them
        assert float(got[2]) == 0.0
        live_k = torch.gather(live, 1, idx).reshape(-1)
        assert torch.equal(feats[live_k], tfg.sample_feature_fused(
            tf, "appearance", xyz_k.reshape(-1, 3))[live_k])


@pytest.mark.parametrize("cap", [2, 7])
def test_render_rays_dedup_matches_jax(slab, cap):
    """render_rays with head_dedup_cells against the JAX package's: maps
    within F32_BAR, dedup_tail equal; where dedup_tail is 0, the port's maps
    equal its render without dedup bit for bit."""
    jp, jm, jr, js, jf = slab["j"]
    tp, tm, tr, ts, tf = slab["t"]
    rays = _both_rays(256, 7)
    kw = dict(max_subsegments=8, term_first=0, head_topk=8,
              head_tail_complete=True, head_dedup_cells=cap)
    want = jR.render_rays(jp, jm, dataclasses.replace(jr, **kw), js,
                          jnp.asarray(rays), None, False, fused=jf)
    got = tR.render_rays(tp, tm, dataclasses.replace(tr, **kw), ts,
                         torch.from_numpy(rays), fused=tf)
    for key in MAP_KEYS + ("opacity", "head_tail", "budget_tail"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **F32_BAR, err_msg=key)
    assert float(got["dedup_tail"]) == float(want["dedup_tail"])
    assert (float(got["dedup_tail"]) > 0) == (cap == 2)
    if cap == 7:
        plain = tR.render_rays(
            tp, tm, dataclasses.replace(tr, **{**kw, "head_dedup_cells": None}),
            ts, torch.from_numpy(rays), fused=tf)
        for key in MAP_KEYS:
            assert torch.equal(got[key], plain[key]), key


def test_span_rows_required_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        units = rng.uniform(0.01, 0.2, 3).astype(np.float32)
        step = float(rng.uniform(0.002, 0.3))
        n = int(rng.integers(1, 33))
        assert (tfg.span_rows_required(units, step, n)
                == jfg.span_rows_required(units, step, n))


def _spans(tf, ts, n_rays, T, seed, step_scale=1.0):
    """[R, 3, T, 3] coordinates of 3 spans of T consecutive samples on each
    of ``n_rays`` random rays through the box, ``step_scale`` times the
    render's step apart, and the spans' sample validity."""
    rng = np.random.default_rng(seed)
    rays = _both_rays(n_rays, seed)
    o, d, t_min = tR._ray_tmin(ts, torch.from_numpy(rays))
    start = torch.from_numpy(rng.integers(0, 60, (n_rays, 3, 1))).float()
    steps = (start + torch.arange(T) * step_scale)[..., None]
    z = t_min[:, None, None, None] + steps * ts.step_size
    xyz = o[:, None, None] + d[:, None, None] * z
    return tR.normalize_coordinates(ts, xyz).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,step_scale", [(4, 1.0), (2, 1.0), (3, 6.0)])
def test_span_plain_version_matches_jax(field, dtype, rows, step_scale):
    """The span form's plain version against the JAX
    sample_density_brick_span on the same atlas and spans, with spans that
    need their clamp (2 rows, or samples 6 steps apart) and spans that do
    not: within F32_BAR. Where validate_fine_span admits the rows, it equals
    the port's per-sample density bit for bit."""
    jf, tf = field["j"][4], field["t"][4]
    ts = field["t"][3]
    shift = field["t"][1].splus_density_shift
    tatlas = tf.brick_atlas.to(getattr(torch, dtype))
    jatlas = jnp.asarray(tf.brick_atlas.numpy()).astype(getattr(jnp, dtype))
    xyz = _spans(tf, ts, 200, 8, 3, step_scale)
    got = bi.sample_density_brick_span(tatlas, xyz, tf.grid_dim, shift, rows)
    want = jfg.sample_density_brick_span(jf._replace(brick_atlas=jatlas),
                                         jnp.asarray(xyz.numpy()), shift, rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_BAR)
    per_sample = bi.sample_density_brick(tatlas, xyz.reshape(-1, 3),
                                         tf.grid_dim, shift).reshape(got.shape)
    need = tfg.span_rows_required(ts.units.numpy(), float(ts.step_size), 8)
    if step_scale == 1.0 and rows >= need:
        assert torch.equal(got, per_sample)
    else:
        # the clamp moves some samples into another brick's row
        assert not torch.equal(got, per_sample)


def test_validate_fine_span(field):
    """validate_fine_span passes at span_rows_required rows and raises
    ValueError below it, as the JAX function does, and also where the
    render has no spans (no coarse_stride), where the JAX function raises
    TypeError."""
    jr, js = field["j"][2], field["j"][3]
    tr, ts = field["t"][2], field["t"][3]
    need = tfg.span_rows_required(ts.units.numpy(), float(ts.step_size),
                                  tr.sub_stride)
    assert need == 4
    tR.validate_fine_span(dataclasses.replace(tr, fine_span_rows=need), ts)
    short = dict(fine_span_rows=need - 1)
    with pytest.raises(ValueError, match="fine_span_rows=3"):
        tR.validate_fine_span(dataclasses.replace(tr, **short), ts)
    with pytest.raises(ValueError, match="fine_span_rows=3"):
        jR.validate_fine_span(dataclasses.replace(jr, **short), js)
    dense = dict(coarse_stride=None, sub_stride=None, use_l1=True,
                 fine_span_rows=need)
    with pytest.raises(ValueError, match="coarse_stride"):
        tR.validate_fine_span(dataclasses.replace(tr, **dense), ts)
    with pytest.raises(TypeError):
        jR.validate_fine_span(dataclasses.replace(jr, **dense), js)


def test_baked_heads_match_jax_node_exact_and_bounded(field):
    """bake_head_tables: the baked values at voxel nodes inside occupied
    blocks are the heads' outputs there and the JAX package's (both bf16
    payloads: 3e-2); render_rays with the baked table within 3e-2 of the
    JAX package's baked render; against the port's own exact heads, rgb
    untouched and the drift bounded as tests/test_bake_heads.py bounds the
    JAX package's."""
    jp, jm, jr, js, jf = field["j"]
    tp, tm, tr, ts, tf = field["t"]
    with pytest.raises(ValueError, match="compact"):
        tbake.bake_head_tables(tp, tm, tf._replace(slot_map=None))
    jb = j_bake(jp, jm, jf)
    tb = tbake.bake_head_tables(tp, tm, tf)
    F = tbake.baked_width(tm)
    assert tb.features["baked"].shape == (14 ** 3, F)
    assert tb.features["baked"].dtype == torch.bfloat16
    occ = tf.slot_map.numpy().reshape(tf.coarse_dim) > 0
    bx, by, bz = np.argwhere(occ)[0]
    nodes_i = (np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"),
                        -1).reshape(-1, 3) + np.array([bx, by, bz]) * 4 + 1)
    nodes = (nodes_i / 13 * 2.0 - 1.0).astype(np.float32)
    got = tfg.sample_feature_fused(tb, "baked", torch.from_numpy(nodes))
    want = jfg.sample_feature_fused(jb, "baked", jnp.asarray(nodes), out_dim=F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_BAR)
    C = tm.num_semantic_classes
    sem = ttf.mlp_apply(tp["semantic_mlp"],
                        ttf._head_input(tm, tm.pe_sem, torch.from_numpy(nodes),
                                        None), torch.bfloat16)
    ins = ttf.render_instances(tp, tm, torch.from_numpy(nodes),
                               compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got[:, :C].numpy(), sem.numpy(), rtol=0.03,
                               atol=0.03)
    np.testing.assert_allclose(got[:, C:].numpy(), ins.numpy(), rtol=0.03,
                               atol=0.03)
    rays = _both_rays(256, 8)
    kw = dict(max_subsegments=8, term_first=0, head_topk=8, head_term_first=4,
              head_tail_complete=True)
    want = jR.render_rays(jp, jm, dataclasses.replace(jr, **kw), js,
                          jnp.asarray(rays), None, False, fused=jb)
    out_b = tR.render_rays(tp, tm, dataclasses.replace(tr, **kw), ts,
                           torch.from_numpy(rays), fused=tb)
    for key in MAP_KEYS:
        np.testing.assert_allclose(out_b[key].numpy(), np.asarray(want[key]),
                                   **BF16_BAR, err_msg=key)
    # the baked render skips the two-phase heads, as the JAX package's
    one_pass = dataclasses.replace(tr, **{**kw, "head_term_first": 0})
    exact = tR.render_rays(tp, tm, one_pass, ts, torch.from_numpy(rays),
                           fused=tf)
    hit = np.abs(exact["instances"].numpy()).sum(-1) > 0
    assert hit.mean() > 0.2
    np.testing.assert_allclose(out_b["rgb"].numpy(), exact["rgb"].numpy(),
                               atol=1e-5)
    agree = (out_b["semantics"].argmax(-1) == exact["semantics"].argmax(-1))
    assert agree.numpy()[hit].mean() > 0.97
    err = np.abs(out_b["instances"].numpy() - exact["instances"].numpy())
    scale = np.abs(exact["instances"].numpy()).max() + 1e-6
    assert np.quantile(err, 0.99) / scale < 0.15


def _messages(caught, module):
    return [str(w.message) for w in caught if w.filename == module.__file__]


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_every_option_renders_like_jax(tmp_path, monkeypatch, option):
    """render_frames at the production point (float32 heads) with each
    option of fidelity.OPTIONS, on two frames of 128-ray chunks: the same
    calibrated config and guardrail warnings as the JAX package's
    render_frames, maps within F32_BAR (3e-2 with baked heads)."""
    changes, kw = OPTIONS[option]
    ckpt = _fog_checkpoint(tmp_path / "field.npz")
    (jp, jm, jr, js), (tp, tm, tr, ts) = _load(ckpt)
    jr = dataclasses.replace(jr, **changes)
    tr = dataclasses.replace(tr, **changes)
    seen = []
    real = jR.calibrate_budgets
    monkeypatch.setattr(jR, "calibrate_budgets",
                        lambda *a, **k: seen.append(real(*a, **k)) or seen[-1])
    rays = [_both_rays(300, 1), _rays(200, 2)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = jrender.render_frames(
            jp, jm, jr, js,
            [JFrame(str(i), r, *([None] * 6)) for i, r in enumerate(rays)],
            chunk=128, **kw)
        got = trender.render_frames_report(
            tp, tm, tr, ts,
            [TFrame(str(i), r, *([None] * 6)) for i, r in enumerate(rays)],
            chunk=128, device="cpu", **kw)
    assert dataclasses.asdict(got.rcfg) == dataclasses.asdict(seen[0])
    assert got.rcfg.use_l1 == (option == "l1")
    assert (got.rcfg.max_subsegments_light > 0) == (option == "no_term")
    assert _messages(caught, trender) == _messages(caught, jrender)
    bar = BF16_BAR if option == "baked" else F32_BAR
    for w, g in zip(want, got.maps):
        assert np.mean(np.abs(w["instances"]).sum(-1) > 0) > 0.1
        for key in MAP_KEYS:
            np.testing.assert_allclose(g[key], w[key], **bar,
                                       err_msg=f"{option}: {key}")


@pytest.mark.parametrize("flag", ["--l1", "--no-term"])
def test_render_cli_options_match_jax(cli_run, flag):  # noqa: F811
    """The render CLI with --l1 and with --no-term on a SceneWriter run
    directory, both packages: the same artifact tree (npy within 2e-5, PNGs
    on 99.9% of the pixels), each scored by its evaluate CLI within
    0.005."""
    tmp, scene, ckpt = cli_run
    args = ["--ckpt_path", str(ckpt), "--image_dim", *map(str, SCENE_HW),
            "--chunk", "256", flag]
    name = flag.strip("-").replace("-", "_")
    j_out, t_out = tmp / f"jax_{name}", tmp / f"torch_{name}"
    j_render_cli.main(args + ["--output_dir", str(j_out)])
    t_render_cli.main(args + ["--output_dir", str(t_out), "--device", "cpu"])
    _assert_trees_match(j_out, t_out)
    scores = []
    for cli, out in ((j_eval_cli, j_out), (t_eval_cli, t_out)):
        cli.main(["--root_path", str(scene), "--exp_path", str(out),
                  "--image_size", *map(str, SCENE_HW)])
        scores.append({k: float(v) for k, v in (
            line.split(": ") for line in
            (out / "metrics.txt").read_text().splitlines())})
    for key in scores[0]:
        assert abs(scores[1][key] - scores[0][key]) <= 0.005, key
