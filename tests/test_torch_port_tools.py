"""Slice 3a of the port against the JAX package, on the CPU: the
calibration, bounding-box, legacy-render and scene-editing tools and the
reference-checkpoint importer.

- ``utils/transforms.py`` and the geometry of ``utils/geometry.py`` that the
  readers do not use (projection, NDC rays, undistortion): within 1e-6
  (projected pixel coordinates, up to 36, within 1e-4).
- ``data/trajectory.py``: the orbit's poses and the rays of each pose equal.
- ``utils/points.py``: the same PLY and OBJ text.
- ``inference/bboxes.py``: every box method on seeded point clouds within
  1e-6, ``instance_bounding_boxes`` included.
- ``inference/calibrate.py`` on the grid-14 field with float32 heads: the
  sweep grids and the thing folding equal; ``find_bandwidth`` on 3 values
  (PQ within 0.005, the same best value) and ``extract_train_centroids``
  (centroids within 1e-4).
- ``renderer/editing.py``: each of the four edits, maps within 2e-5 (the
  semantics on rays of opacity 1e-4 and more).
- ``renderer/occupancy.py::get_instance_clusters``: points and labels equal.
- ``io/torch_import.py``: the converted tree and the written npz equal to
  the JAX converter's, array for array, on a reference-layout state dict
  (``inference/fidelity.py::reference_like_state_dict``).
- The find_bandwidth, extract_centroids, visualize_bboxes and render_legacy
  CLIs of both packages on a PanopLi scene written by ``SceneWriter``.
- Every new entry point asks for the card by default and raises without
  one.
"""
import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from contrastive_lift_tpu.cli import extract_centroids as j_extract_cli
from contrastive_lift_tpu.cli import find_bandwidth as j_bandwidth_cli
from contrastive_lift_tpu.cli import render_legacy as j_legacy_cli
from contrastive_lift_tpu.cli import visualize_bboxes as j_bboxes_cli
from contrastive_lift_tpu.data import trajectory as jtraj
from contrastive_lift_tpu.data.base import FrameData as JFrame
from contrastive_lift_tpu.inference import bboxes as jbboxes
from contrastive_lift_tpu.inference import calibrate as jcal
from contrastive_lift_tpu.inference import render as jrender
from contrastive_lift_tpu.io import checkpoint as jckpt
from contrastive_lift_tpu.io import torch_import as jimport
from contrastive_lift_tpu.renderer import editing as jedit
from contrastive_lift_tpu.renderer import occupancy as jocc
from contrastive_lift_tpu.utils import geometry as jgeo
from contrastive_lift_tpu.utils import points as jpoints
from contrastive_lift_tpu.utils import transforms as jtr
from contrastive_lift_tpu_torch.cli import extract_centroids as t_extract_cli
from contrastive_lift_tpu_torch.cli import find_bandwidth as t_bandwidth_cli
from contrastive_lift_tpu_torch.cli import render_legacy as t_legacy_cli
from contrastive_lift_tpu_torch.cli import visualize_bboxes as t_bboxes_cli
from contrastive_lift_tpu_torch.data import trajectory as ttraj
from contrastive_lift_tpu_torch.data.base import FrameData as TFrame
from contrastive_lift_tpu_torch.factory import build_model as t_build_model
from contrastive_lift_tpu_torch.inference import bboxes as tbboxes
from contrastive_lift_tpu_torch.inference import calibrate as tcal
from contrastive_lift_tpu_torch.inference import render as trender
from contrastive_lift_tpu_torch.inference.fidelity import (
    reference_like_state_dict)
from contrastive_lift_tpu_torch.io import checkpoint as tckpt
from contrastive_lift_tpu_torch.io import torch_import as timport
from contrastive_lift_tpu_torch.renderer import editing as tedit
from contrastive_lift_tpu_torch.renderer import occupancy as tocc
from contrastive_lift_tpu_torch.renderer import render as tR
from contrastive_lift_tpu_torch.utils import geometry as tgeo
from contrastive_lift_tpu_torch.utils import points as tpoints
from contrastive_lift_tpu_torch.utils import transforms as ttr
from test_torch_port_cli import SCENE_HW, _mixed_checkpoint
from test_torch_port_readers import write_panopli_scene
from test_torch_port_render import JConfig, TConfig, _cfg, _rays

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(2)

MAP_KEYS = ("rgb", "semantics", "instances", "depth")
# the editing test's box (inside the grid-14 field's opaque slab) and move
BOX = {"extent": [0.9, 0.7, 0.4], "position": [-0.15, 0.1, 0.05],
       "orientation": None}
THETA = np.deg2rad(30.0)
ROTATION = np.array([[np.cos(THETA), -np.sin(THETA), 0.0],
                     [np.sin(THETA), np.cos(THETA), 0.0],
                     [0.0, 0.0, 1.0]], np.float32)
TRANSLATION = np.array([0.3, -0.1, 0.0], np.float32)


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


def _box():
    return dict(BOX, orientation=_rotation(3))


# ---------------------------------------------------------------------------
# transforms, geometry, trajectories, point export
# ---------------------------------------------------------------------------

def test_transforms_match_jax():
    rot, t = _rotation(0), np.array([0.3, -1.2, 2.0], np.float32)
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttr.hmg(rot), jtr.hmg(rot))
    np.testing.assert_array_equal(ttr.hmg(torch.from_numpy(rot)).numpy(),
                                  np.asarray(jtr.hmg(jnp.asarray(rot))))
    for scale in (1.0, [0.5, 2.0, 3.0]):
        np.testing.assert_array_equal(ttr.trs_comp(t, rot, scale),
                                      jtr.trs_comp(t, rot, scale))
    tr = ttr.tr_comp(t, rot)
    np.testing.assert_array_equal(tr, jtr.tr_comp(t, rot))
    for m in (rot, tr[:3], tr):
        want = np.asarray(jtr.dot(jnp.asarray(m), jnp.asarray(pts)))
        np.testing.assert_allclose(ttr.dot(m, pts), want, atol=1e-6)
        np.testing.assert_allclose(ttr.dot(torch.from_numpy(m), pts).numpy(),
                                   want, atol=1e-6)
    np.testing.assert_allclose(ttr.inverse_rigid(tr), jtr.inverse_rigid(tr),
                               atol=1e-6)
    got = ttr.inverse_rigid(torch.from_numpy(tr)).numpy()
    np.testing.assert_allclose(got, np.asarray(jtr.inverse_rigid(
        jnp.asarray(tr))), atol=1e-6)
    np.testing.assert_allclose(got @ tr, np.eye(4), atol=1e-6)


K = np.array([[40.0, 0, 17.5], [0, 38.0, 11.0], [0, 0, 1]], np.float32)
DISTORTION = (0.05, -0.02, 0.004, 0.001, 0.002, -0.001)


def test_geometry_matches_jax():
    h, w = 24, 36
    rng = np.random.default_rng(2)
    c2w = ttr.tr_comp([0.2, -0.4, 1.5], _rotation(4))
    depth = rng.uniform(0.5, 3.0, h * w).astype(np.float32)
    pts = tgeo.unproject_2d_3d(c2w, K, depth, h, w)
    np.testing.assert_allclose(
        pts, np.asarray(jgeo.unproject_2d_3d(c2w, K, depth, h, w)), atol=1e-6)
    pix = tgeo.project_3d_2d(c2w, K, pts)
    np.testing.assert_allclose(
        pix, np.asarray(jgeo.project_3d_2d(c2w, K, jnp.asarray(pts))),
        atol=1e-4)    # pixel units, |x| < 36: float32 steps of 4e-6
    i, j = tgeo.pixel_grid(h, w)
    np.testing.assert_allclose(pix, np.stack([i.reshape(-1), j.reshape(-1)],
                                             -1), atol=2e-3)
    rays_o = rng.normal(0, 0.2, (60, 3)).astype(np.float32)
    rays_d = rng.normal(size=(60, 3)).astype(np.float32)
    rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 0.5
    for got, want in zip(tgeo.ndc_rays(h, w, 40.0, 1.0, rays_o, rays_d),
                         jgeo.ndc_rays(h, w, 40.0, 1.0, jnp.asarray(rays_o),
                                       jnp.asarray(rays_d))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        tgeo.ray_directions_undistorted(h, w, K, DISTORTION[:4]),
        np.asarray(jgeo.ray_directions_undistorted(h, w, K, DISTORTION[:4])),
        atol=1e-6)
    xd = rng.uniform(-0.6, 0.6, 200).astype(np.float32)
    yd = rng.uniform(-0.6, 0.6, 200).astype(np.float32)
    got = tgeo.radial_tangential_undistort(xd, yd, *DISTORTION)
    want = jgeo.radial_tangential_undistort(xd, yd, *DISTORTION)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    # the undistorted point distorts back onto the input
    res = tgeo._undistort_residual_jacobian(*got, xd, yd, *DISTORTION)
    np.testing.assert_allclose(res[:2], 0.0, atol=1e-5)
    for a, b in zip(res, jgeo._undistort_residual_jacobian(
            *got, xd, yd, *DISTORTION)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)


def test_trajectories_match_jax(tmp_path):
    for kw in ({}, dict(radius=0.4, height=-0.1, target=(0.1, 0.2, 0.0),
                        revolutions=0.5), dict(height=5.0)):
        j_poses = jtraj.spherical_orbit(5, **kw)
        t_poses = ttraj.spherical_orbit(5, **kw)
        for a, b in zip(t_poses, j_poses):
            np.testing.assert_array_equal(a, b)
    poses = ttraj.spherical_orbit(3)
    t_frames = ttraj.rays_for_poses(poses, K, (12, 20))
    j_frames = jtraj.rays_for_poses(poses, K, (12, 20))
    for a, b in zip(t_frames, j_frames):
        assert a.name == b.name
        np.testing.assert_allclose(a.rays, b.rays, atol=1e-6)
        np.testing.assert_array_equal(a.cam2normscene, b.cam2normscene)
        assert a.rgbs.shape == b.rgbs.shape and a.mask.all()
    scale = np.diag([0.5, 0.5, 0.5, 1.0]).astype(np.float32)
    for i, data in enumerate((poses, {"poses": poses})):
        path = tmp_path / f"poses{i}.pkl"
        path.write_bytes(pickle.dumps(data))
        for a, b in zip(ttraj.load_trajectory(path, K, (8, 10), scale),
                        jtraj.load_trajectory(path, K, (8, 10), scale)):
            np.testing.assert_allclose(a.rays, b.rays, atol=1e-6)


def test_point_exports_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    cols = rng.uniform(-0.1, 1.1, (40, 3))
    c2ws = ttraj.spherical_orbit(4)
    for pkg, name in ((tpoints, "t"), (jpoints, "j")):
        pkg.save_ply(tmp_path / f"{name}.ply", pts, cols)
        pkg.save_ply(tmp_path / f"{name}_plain.ply", pts)
        pkg.save_obj_points(tmp_path / f"{name}.obj", pts, cols)
        pkg.export_camera_poses(tmp_path / f"{name}_cams.obj", c2ws, K,
                                (24, 36))
    for suffix in (".ply", "_plain.ply", ".obj", "_cams.obj"):
        assert ((tmp_path / f"t{suffix}").read_text()
                == (tmp_path / f"j{suffix}").read_text()), suffix
    np.testing.assert_array_equal(
        tpoints.camera_frustum_points(c2ws[1], K, (24, 36), 0.3),
        jpoints.camera_frustum_points(c2ws[1], K, (24, 36), 0.3))
    frames = ttraj.rays_for_poses(c2ws[:2], K, (6, 8))
    for f in frames:
        f.depth = rng.uniform(0.2, 1.0, 48).astype(np.float32)
        f.semantics = rng.integers(0, 3, 48)
    for pkg, name in ((tpoints, "t"), (jpoints, "j")):
        pkg.export_scene_point_cloud(tmp_path / f"{name}_scene.ply", frames,
                                     subsample=3, color_by="semantics")
    assert ((tmp_path / "t_scene.ply").read_text()
            == (tmp_path / "j_scene.ply").read_text())


def test_plot_camera_poses_needs_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is missing, as on the card's machine, the plot
    raises ImportError naming it."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tpoints.plot_camera_poses(tmp_path / "poses.png",
                                  ttraj.spherical_orbit(3))


# ---------------------------------------------------------------------------
# bounding boxes
# ---------------------------------------------------------------------------

def _cloud(seed, n=300):
    """An elongated, rotated, noisy box-shaped cloud with a few outliers."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)) * np.array([0.6, 0.25, 0.15])
    pts = pts @ _rotation(seed + 10).T.astype(np.float64) + rng.normal(size=3)
    pts[:5] += rng.normal(0, 2.0, (5, 3))
    return pts


def _assert_boxes_close(got, want, atol=1e-6):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("method", sorted(jbboxes.BOX_METHODS))
def test_box_methods_match_jax(method):
    for seed in range(3):
        pts = _cloud(seed)
        _assert_boxes_close(tbboxes.BOX_METHODS[method](pts),
                            jbboxes.BOX_METHODS[method](pts))


def test_box_helpers_match_jax():
    pts = _cloud(7)
    np.testing.assert_array_equal(tbboxes.filter_points_by_density(pts),
                                  jbboxes.filter_points_by_density(pts))
    a, c = tbboxes.min_volume_ellipsoid(pts)
    ja, jc = jbboxes.min_volume_ellipsoid(pts)
    np.testing.assert_allclose(a, ja, atol=1e-6)
    np.testing.assert_allclose(c, jc, atol=1e-6)
    for got, want in zip(tbboxes.minimum_bounding_rectangle(pts[:, :2]),
                         jbboxes.minimum_bounding_rectangle(pts[:, :2])):
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("method", ["aabb", "mbr"])
def test_instance_bounding_boxes_match_jax(method):
    pts = np.concatenate([_cloud(s, 120) for s in range(4)])
    ids = np.repeat([0, 3, 1, 7], 120)
    ids[:10] = 5                             # under min_points: skipped
    for density_filter in (True, False):
        got = tbboxes.instance_bounding_boxes(pts, ids, method,
                                              density_filter=density_filter)
        want = jbboxes.instance_bounding_boxes(pts, ids, method,
                                               density_filter=density_filter)
        assert sorted(got) == sorted(want) == [1, 3, 7]
        for k in want:
            _assert_boxes_close(got[k], want[k])


# ---------------------------------------------------------------------------
# calibration, editing, instance clusters on the grid-14 field
# ---------------------------------------------------------------------------

def test_sweep_values_and_folding_match_jax():
    for max_instances in (3, 16, 25):
        for dataset_class in ("panopli", "mos"):
            for use_dbscan in (False, True):
                kw = dict(max_instances=max_instances,
                          dataset_class=dataset_class)
                is_mos = dataset_class == "mos"
                np.testing.assert_array_equal(
                    tcal.sweep_values(TConfig(**kw), use_dbscan, is_mos),
                    jcal.sweep_values(JConfig(**kw), use_dbscan, is_mos))
    # the reference's arange: 25 values, or 50 on a MOS scene
    assert len(tcal.sweep_values(TConfig(max_instances=3), False, False)) == 25
    assert len(tcal.sweep_values(TConfig(max_instances=3), False, True)) == 50
    sem = np.random.default_rng(0).uniform(size=(40, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tcal.modify_things_to_singleclass(sem, [2, 4, 3]),
        jcal.modify_things_to_singleclass(sem, [2, 4, 3]))


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    """The grid-14 mixed field (both classes show up), loaded by both
    packages with float32 heads, and two frames of ``_rays`` whose machine
    labels are the JAX render's semantics and its mean-shift instances at
    bandwidth 0.15 (so that the bandwidth sweep's PQ has signal)."""
    from contrastive_lift_tpu.inference.cluster import (
        cluster, create_instances_from_semantics)
    ckpt = _mixed_checkpoint(tmp_path_factory.mktemp("field") / "field.npz")
    j = jrender.load_model_for_inference(ckpt, _cfg(JConfig), 2)[:4]
    t = trender.load_model_for_inference(ckpt, _cfg(TConfig), 2,
                                         device="cpu")[:4]
    rays = [_rays(16 * 24, 20 + i) for i in range(2)]
    maps = jrender.render_frames(
        *j, [JFrame(f"{i:04d}", r, *([None] * 6)) for i, r in enumerate(rays)],
        256)
    sem = np.concatenate([m["semantics"] for m in maps])
    feats = create_instances_from_semantics(
        np.concatenate([m["instances"][:, :3] for m in maps]), sem, [1])
    inst = np.asarray(cluster(feats, 0.15, 2)).argmax(-1)
    frames = {pkg: [Frame(f"{i:04d}", r, None, sem.argmax(-1).reshape(2, -1)[i],
                          inst[i], None, None, None)
                    for i, r in enumerate(rays)]
              for pkg, Frame in (("jax", JFrame), ("torch", TFrame))}
    return ckpt, j, t, frames


def test_find_bandwidth_matches_jax(field, tmp_path):
    _, j, t, frames = field
    sweep = np.array([0.08, 0.15, 0.3])
    kw = dict(chunk=256, sweep=sweep)
    want = jcal.find_bandwidth(*j, _cfg(JConfig), frames["jax"], [1],
                               output_dir=tmp_path / "jax", **kw)
    got = tcal.find_bandwidth(*t, _cfg(TConfig), frames["torch"], [1],
                              output_dir=tmp_path / "torch", device="cpu",
                              **kw)
    assert got["mode"] == want["mode"] == "bandwidth"
    assert [v for v, _ in got["curve"]] == [v for v, _ in want["curve"]]
    assert len(want["curve"]) == 3
    for (_, a), (_, b) in zip(got["curve"], want["curve"]):
        assert abs(a - b) <= 0.005
    assert got["best_value"] == want["best_value"]
    assert max(pq for _, pq in want["curve"]) > 0     # the curve has signal
    np.testing.assert_allclose(
        np.load(tmp_path / "torch" / "all_thing_features_train.npy"),
        np.load(tmp_path / "jax" / "all_thing_features_train.npy"),
        atol=2e-5)


def test_find_bandwidth_ties_and_degenerate_values(field, monkeypatch):
    """The last of equal bests wins; a value whose clustering raises
    ValueError is skipped; any other error propagates."""
    _, _, t, frames = field
    calls = []

    def fake_cluster(feats, bw, num_images, **kw):
        calls.append(bw)
        if bw == 0.2:
            raise ValueError("No point was within bandwidth of any seed.")
        if bw == 0.9:
            raise RuntimeError("CUDA error: an illegal memory access")
        onehot = np.zeros((num_images, feats.shape[0] // num_images, 2),
                          np.float32)
        onehot[..., 0] = 1.0
        return onehot

    monkeypatch.setattr(tcal, "cluster", fake_cluster)
    res = tcal.find_bandwidth(*t, _cfg(TConfig), frames["torch"], [1],
                              chunk=256, sweep=np.array([0.1, 0.2, 0.3]),
                              device="cpu")
    assert [v for v, _ in res["curve"]] == [0.1, 0.3]
    assert res["curve"][0][1] == res["curve"][1][1]
    assert res["best_value"] == 0.3
    with pytest.raises(RuntimeError, match="CUDA"):
        tcal.find_bandwidth(*t, _cfg(TConfig), frames["torch"], [1],
                            chunk=256, sweep=np.array([0.9]), device="cpu")


def test_extract_train_centroids_matches_jax(field, tmp_path):
    _, j, t, frames = field
    # at bandwidth 0.05 the thing pixels' embeddings give 60 modes
    want = jcal.extract_train_centroids(
        *j, _cfg(JConfig), frames["jax"], [1], bandwidth=0.05, chunk=256,
        output_path=tmp_path / "j.pkl")
    got = tcal.extract_train_centroids(
        *t, _cfg(TConfig), frames["torch"], [1], bandwidth=0.05, chunk=256,
        output_path=tmp_path / "t.pkl", device="cpu")
    with open(tmp_path / "t.pkl", "rb") as f:
        stored = pickle.load(f)
    assert sorted(got) == sorted(want) == sorted(stored) == [1]
    assert len(want[1]) >= 2
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)
    np.testing.assert_array_equal(stored[1], got[1])


EDITS = ("delete", "extract", "duplicate", "manipulate")


@pytest.mark.parametrize("kind", EDITS)
def test_render_edited_matches_jax(field, kind):
    """Maps within 2e-5 of the JAX package's. The semantics are compared on
    rays whose opacity reaches 1e-4: below, the 1e-8 of the softmax
    normalisation competes with the weights, whose float32 roundings of
    1 - exp(-x) differ by a percent (a ray of opacity 3e-7 differs by 4e-3
    in probability). Delete and extract keep the rays that miss the box and
    lower (delete) or zero (extract) the opacity of the rest."""
    _, (jp, jm, jr, js), (tp, tm, tr, ts), _ = field
    rays = _rays(96, 7)
    box = _box()
    move = (dict(translation=TRANSLATION, rotation=ROTATION)
            if kind in ("duplicate", "manipulate") else {})
    want = jedit.render_edited(jp, jm, jr, js, jnp.asarray(rays), kind, box,
                               **move)
    got = tedit.render_edited(tp, tm, tr, ts, rays, kind, box, device="cpu",
                              **move)
    rays_t = torch.from_numpy(rays)
    base = tedit.edited_weights(tp, tm, tr, ts, rays_t, None, box)[2].sum(-1)
    edited = tedit.edited_weights(tp, tm, tr, ts, rays_t, kind, box,
                                  **move)[2].sum(-1)
    lit = (edited >= 1e-4).numpy()
    for key in MAP_KEYS:
        g, w = got[key].numpy(), np.asarray(want[key])
        if key == "semantics":
            g, w = g[lit], w[lit]
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0, err_msg=key)
    xyz, _, in_box = tR.sample_points_in_box(rays_t, ts, tr.n_samples)
    hits = (tedit.points_in_oriented_box(
        xyz.reshape(-1, 3), box["extent"], box["position"],
        box["orientation"]).reshape(in_box.shape) & in_box).any(-1)
    assert hits.any() and not hits.all()
    changed = (edited - base).abs() > 1e-3
    assert changed.any() and not changed.all()
    if kind in ("delete", "extract"):
        assert bool((edited <= base + 1e-6).all())
    if kind == "delete":
        assert bool((edited[hits] < base[hits] - 1e-3).any())
        assert torch.equal(edited[~hits], base[~hits])
    if kind == "extract":
        assert bool((edited[~hits] == 0).all())


def test_points_in_oriented_box_matches_jax():
    xyz = np.random.default_rng(8).uniform(-1, 1, (500, 3)).astype(np.float32)
    box = _box()
    got = tedit.points_in_oriented_box(torch.from_numpy(xyz), box["extent"],
                                       box["position"], box["orientation"])
    want = jedit.points_in_oriented_box(jnp.asarray(xyz), box["extent"],
                                        box["position"], box["orientation"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < len(xyz)


def test_get_instance_clusters_matches_jax(field, tmp_path):
    _, (jp, jm, _, js), (tp, tm, _, ts), _ = field
    for mode, cap in (("alpha", None), ("full", 500)):
        want = jocc.get_instance_clusters(jp, jm, js, (14, 14, 14), mode,
                                          max_samples=cap)
        got = tocc.get_instance_clusters(tp, tm, ts, (14, 14, 14), mode,
                                         max_samples=cap, device="cpu")
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])
        assert len(got[0]) == (cap or int(np.prod([14] * 3)))  \
            or mode == "alpha"
    tocc.export_instance_clusters(tp, tm, ts, (14, 14, 14), tmp_path,
                                  device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["alpha.obj",
                                                          "full.obj"]


# ---------------------------------------------------------------------------
# the importer
# ---------------------------------------------------------------------------

IMPORT_VARIANTS = {
    # r5b's heads: xyz MLPs for semantics and both instance branches
    "mlp_heads": dict(),
    # grid-branch semantic and instance heads with the DINO projection
    "grid_heads_proj": dict(use_mlp_for_semantics=False,
                            use_mlp_for_instances=False, use_proj=True),
}


def _template(variant):
    """The port's parameter tree of the variant at grid (10, 12, 9)."""
    cfg = _cfg(TConfig, **IMPORT_VARIANTS[variant])
    return t_build_model(cfg, 3, np.array([[-1.0] * 3, [1.0] * 3], np.float32),
                         (10, 12, 9), device="cpu")[1]


@pytest.mark.parametrize("variant", sorted(IMPORT_VARIANTS))
def test_convert_state_dict_matches_jax(variant):
    template = _template(variant)
    bbox = [[-1.0, -0.5, -0.8], [0.9, 1.0, 0.7]]
    sd = reference_like_state_dict(template, (10, 12, 9), bbox, seed=4)
    got, got_meta = timport.convert_state_dict(sd)
    want, want_meta = jimport.convert_state_dict(sd)
    assert got_meta == want_meta
    assert got_meta["grid_dim"] == [10, 12, 9]
    flat_got = jckpt._flatten_with_paths(got)
    flat_want = jckpt._flatten_with_paths(want)
    assert sorted(flat_got) == sorted(flat_want) == sorted(
        jckpt._flatten_with_paths(template))
    for key, value in flat_want.items():
        assert flat_got[key].dtype == np.float32
        np.testing.assert_array_equal(flat_got[key], value, err_msg=key)
        assert value.shape == jckpt._flatten_with_paths(template)[key].shape
    # the same draws from the same seed
    again = reference_like_state_dict(template, (10, 12, 9), bbox, seed=4)
    assert all(torch.equal(again[k], sd[k]) for k in sd)


def test_convert_torch_checkpoint_matches_jax(tmp_path):
    template = _template("mlp_heads")
    sd = reference_like_state_dict(template, (10, 12, 9),
                                   [[-1.0] * 3, [1.0] * 3], seed=5)
    torch.save({"state_dict": sd, "epoch": 7, "global_step": 3500},
               tmp_path / "ref.ckpt")
    torch.save(sd, tmp_path / "bare.ckpt")   # a plain state dict imports too
    for name in ("ref", "bare"):
        src = tmp_path / f"{name}.ckpt"
        info = timport.convert_torch_checkpoint(src, tmp_path / f"t_{name}.npz")
        assert info == jimport.convert_torch_checkpoint(
            src, tmp_path / f"j_{name}.npz")
        with np.load(tmp_path / f"t_{name}.npz") as t, \
                np.load(tmp_path / f"j_{name}.npz") as j:
            assert t.files == j.files
            for key in j.files:
                if key == "__meta__":
                    assert json.loads(str(t[key])) == json.loads(str(j[key]))
                else:
                    np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    meta = json.loads(str(np.load(tmp_path / "t_ref.npz")["__meta__"]))
    assert (meta["epoch"], meta["global_step"]) == (7, 3500)
    # both packages' loaders read the port's file
    tparams, tmeta = tckpt.load_checkpoint(tmp_path / "t_ref.npz")
    jparams, jmeta = jckpt.load_checkpoint(tmp_path / "t_ref.npz")
    assert tmeta == jmeta and tmeta["grid_dim"] == [10, 12, 9]
    # and the imported field renders on the port's production path
    cfg = _cfg(TConfig)
    model = trender.load_model_for_inference(tmp_path / "t_ref.npz", cfg, 3,
                                             device="cpu")[:4]
    frame = TFrame("0000", _rays(64, 9), *([None] * 6))
    out = trender.render_frames(*model, [frame], chunk=64, device="cpu")[0]
    assert out["instances"].shape == (64, 6)
    assert all(np.isfinite(out[k]).all() for k in MAP_KEYS)
    timport.main(["--ckpt_path", str(tmp_path / "ref.ckpt"), "--output_path",
                  str(tmp_path / "cli.npz")])
    with np.load(tmp_path / "cli.npz") as c, np.load(tmp_path / "t_ref.npz") as t:
        for key in t.files:
            if key != "__meta__":
                np.testing.assert_array_equal(c[key], t[key])


# ---------------------------------------------------------------------------
# the CLIs on a SceneWriter scene
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A run directory whose config points at a SceneWriter scene of two
    classes (5 frames: 3 train, 2 test), with the mixed grid-14 field."""
    tmp = tmp_path_factory.mktemp("tools_cli")
    scene = write_panopli_scene(tmp / "scene", n_frames=5, hw=SCENE_HW,
                                classes=2, features=False)
    run = tmp / "run"
    (run / "checkpoints").mkdir(parents=True)
    _mixed_checkpoint(run / "checkpoints" / "final.npz")
    _cfg(JConfig, dataset_class="panopli", dataset_root=str(scene),
         max_depth=4.0).save(run / "config.json")
    return tmp, run / "checkpoints" / "final.npz"


def _common(ckpt):
    return ["--ckpt_path", str(ckpt), "--image_dim", *map(str, SCENE_HW),
            "--chunk", "256"]


def _printed_json(text: str) -> dict:
    """The JSON object a CLI printed last (after its progress lines)."""
    return json.loads(text[text.rindex("\n{") + 1 if "\n{" in text
                           else text.index("{"):])


def test_find_bandwidth_cli_matches_jax(cli_run, capsys):
    """Both CLIs on the train views at the reference's 25-value grid: the
    same best value and PQ (within 0.005), the same curve."""
    tmp, ckpt = cli_run
    out, curves = {}, {}
    for name, cli, extra in (("jax", j_bandwidth_cli, []),
                             ("torch", t_bandwidth_cli, ["--device", "cpu"])):
        cli.main(_common(ckpt) + ["--output_dir", str(tmp / f"bw_{name}")]
                 + extra)
        text = capsys.readouterr().out
        out[name] = _printed_json(text)
        curves[name] = [tuple(float(x.split(": ")[1]) for x in
                              line.split(", "))
                        for line in text.splitlines()
                        if line.startswith("value: ")]
    assert out["torch"]["mode"] == out["jax"]["mode"] == "bandwidth"
    assert out["torch"]["best_value"] == out["jax"]["best_value"]
    assert abs(out["torch"]["best_pq"] - out["jax"]["best_pq"]) <= 0.005
    assert len(curves["torch"]) == len(curves["jax"]) >= 20
    for (va, pa), (vb, pb) in zip(curves["torch"], curves["jax"]):
        assert va == vb and abs(pa - pb) <= 0.005
    np.testing.assert_allclose(
        np.load(tmp / "bw_torch" / "all_thing_features_train.npy"),
        np.load(tmp / "bw_jax" / "all_thing_features_train.npy"), atol=2e-5)


def test_extract_centroids_cli_matches_jax(cli_run, capsys):
    tmp, ckpt = cli_run
    cents = {}
    for name, cli, extra in (("jax", j_extract_cli, []),
                             ("torch", t_extract_cli, ["--device", "cpu"])):
        path = tmp / f"centroids_{name}.pkl"
        cli.main(_common(ckpt) + ["--output_path", str(path)] + extra)
        with open(path, "rb") as f:
            cents[name] = pickle.load(f)
    assert capsys.readouterr().out.count("wrote ") == 2
    assert sorted(cents["torch"]) == sorted(cents["jax"]) == [1]
    np.testing.assert_allclose(cents["torch"][1], cents["jax"][1], atol=1e-4)


@pytest.mark.parametrize("method", ["mbr", "aabb"])
def test_visualize_bboxes_cli_matches_jax(cli_run, method):
    tmp, ckpt = cli_run
    for name, cli, extra in (("jax", j_bboxes_cli, []),
                             ("torch", t_bboxes_cli, ["--device", "cpu"])):
        cli.main(_common(ckpt) + ["--method", method, "--output_dir",
                                  str(tmp / f"boxes_{method}_{name}")]
                 + extra)
    t_dir, j_dir = (tmp / f"boxes_{method}_{n}" for n in ("torch", "jax"))
    got = json.loads((t_dir / "boxes.json").read_text())
    want = json.loads((j_dir / "boxes.json").read_text())
    assert sorted(got) == sorted(want) and want
    for k in want:
        _assert_boxes_close(got[k], want[k], atol=1e-4)
    t_obj = np.array([line.split()[1:] for line in
                      (t_dir / "points.obj").read_text().splitlines()], float)
    j_obj = np.array([line.split()[1:] for line in
                      (j_dir / "points.obj").read_text().splitlines()], float)
    np.testing.assert_allclose(t_obj, j_obj, atol=1e-4)


@pytest.mark.parametrize("trajectory", [False, True])
def test_render_legacy_cli_matches_jax(cli_run, trajectory):
    """The legacy CLI's PNGs, read back by PIL: semantics and surrogate ids
    equal on at least 99.9% of the pixels, 8- and 16-bit; a visualisation
    per frame."""
    tmp, ckpt = cli_run
    extra = (["--render_trajectory", "--trajectory_frames", "3"]
             if trajectory else [])
    dirs = {}
    for name, cli, dev in (("jax", j_legacy_cli, []),
                           ("torch", t_legacy_cli, ["--device", "cpu"])):
        dirs[name] = tmp / f"legacy_{trajectory}_{name}"
        cli.main(_common(ckpt) + ["--output_dir", str(dirs[name])] + extra
                 + dev)
    names = sorted(p.name for p in (dirs["jax"] / "pred_semantics").iterdir())
    assert len(names) == (3 if trajectory else 2)
    for sub, mode in (("pred_semantics", "L"), ("pred_surrogateid", "I;16")):
        for n in names:
            a = Image.open(dirs["torch"] / sub / n)
            b = Image.open(dirs["jax"] / sub / n)
            assert a.mode == b.mode == mode
            assert (np.array(a) == np.array(b)).mean() >= 0.999, (sub, n)
    assert sorted(p.name for p in (dirs["torch"] / "vis").iterdir()) == names


# ---------------------------------------------------------------------------
# every new entry point asks for the card
# ---------------------------------------------------------------------------

CLIS = {"find_bandwidth": t_bandwidth_cli, "extract_centroids": t_extract_cli,
        "visualize_bboxes": t_bboxes_cli, "render_legacy": t_legacy_cli}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_defaults_to_the_card(cli_run, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the CPU-only behaviour is not shown")
    _, ckpt = cli_run
    with pytest.raises(RuntimeError, match="cuda"):
        CLIS[name].main(["--ckpt_path", str(ckpt)])


def test_functions_default_to_the_card(field):
    """The library entry points ask for ``cuda`` unless told otherwise, and
    raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the CPU-only behaviour is not shown")
    _, _, t, frames = field
    calls = [
        lambda: tcal.find_bandwidth(*t, _cfg(TConfig), frames["torch"], [1],
                                    sweep=np.array([0.1])),
        lambda: tcal.extract_train_centroids(*t, _cfg(TConfig),
                                             frames["torch"], [1]),
        lambda: tcal.render_train_embeddings(*t, _cfg(TConfig),
                                             frames["torch"], [1]),
        lambda: tedit.render_edited(*t, _rays(4, 0), "delete", _box()),
        lambda: tocc.get_instance_clusters(t[0], t[1], t[3], (14, 14, 14)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
