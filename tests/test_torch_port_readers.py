"""The port's PanopLi and MOS readers against the JAX package's, on scenes
PIL writes.

The PanopLi scene is written by the JAX package's ``SceneWriter`` (JPEG
colour at quality 95, 4:2:0; PNG labels, uint16 where ids pass 255; grey
JPEG ``invalid`` masks; probability npz with ``notta`` confidences;
segments; GT; distilled-feature npy), the MOS scene like
``tests/test_data_readers.py``'s (RGBA PNG colour, npy labels and
confidences). Both are read at their own size and resized to a size that is
not an integer ratio of it. Bars: splits, intrinsics, labels, masks and
segments equal; rays, probabilities, confidences and features within 1e-6;
rgb within 1/255, and equal where the colour frames are RGB-coded and CMYK
JPEGs.
"""
import json
import pickle

import numpy as np
import pytest
from PIL import Image

from contrastive_lift_tpu.data import load_scene as j_load_scene
from contrastive_lift_tpu.data.mos import MOSSceneReader as JMOS
from contrastive_lift_tpu.data.panopli import PanopLiSceneReader as JPanopLi
from contrastive_lift_tpu.data.preprocessing.common import SceneWriter
from contrastive_lift_tpu_torch.config import Config as TConfig
from contrastive_lift_tpu_torch.data import load_scene as t_load_scene
from contrastive_lift_tpu_torch.data.mos import MOSSceneReader as TMOS
from contrastive_lift_tpu_torch.data.panopli import PanopLiSceneReader as TPanopLi
from contrastive_lift_tpu_torch.utils import geometry as tgeo

PANOPLI_HW = (30, 44)
MOS_HW = (20, 26)
EXACT = ("semantics", "instances", "mask", "gt_semantics", "gt_instances",
         "segments", "intrinsics")
CLOSE = ("rays", "probabilities", "confidences", "feats", "cam2normscene")


def write_panopli_scene(root, n_frames=5, hw=PANOPLI_HW, classes=4,
                        features=True, notta=False):
    """A PanopLi scene through SceneWriter, with cameras around the
    origin looking at it."""
    rng = np.random.default_rng(0)
    h, w = hw
    writer = SceneWriter(root)
    names = [str(i) for i in range(n_frames)]
    yy, xx = np.mgrid[0:h, 0:w]
    for i, name in enumerate(names):
        angle = 2 * np.pi * i / n_frames
        eye = np.array([2 * np.cos(angle), 2 * np.sin(angle), 1.0])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
            right, np.cross(fwd, right), fwd, eye)
        rgb = np.clip(np.stack([xx * 5 + i * 9, yy * 7, (xx + yy) * 3], -1)
                      + rng.normal(0, 12, (h, w, 3)), 0, 255)
        sem = rng.integers(0, classes, (h, w))
        inst = rng.integers(0, 300 if i % 2 else 6, (h, w))
        probs = rng.dirichlet(np.ones(classes), (h, w)).astype(np.float32)
        conf = rng.uniform(0.5, 1, (h, w)).astype(np.float32)
        writer.add_frame(name, rgb, c2w, sem, inst, probs, conf,
                         gt_semantics=sem, gt_instance=inst,
                         segments=rng.integers(0, 400, (h, w)),
                         invalid=rng.random((h, w)) > 0.8)
        if notta:
            npz = root / "m2f_probabilities" / f"{name}.npz"
            np.savez_compressed(npz, probability=probs, confidence=conf,
                                confidence_notta=conf ** 2)
        if features:
            (root / "features").mkdir(exist_ok=True)
            np.save(root / "features" / f"{name}.npy",
                    rng.normal(size=(h // 2, w // 2, 8)).astype(np.float32))
    writer.write_intrinsics(np.array([[40.0, 0, w / 2, 0], [0, 40.0, h / 2, 0],
                                      [0, 0, 1, 0], [0, 0, 0, 1]]))
    writer.write_splits(names[:3], names[3:])
    writer.write_segmentation_data(list(range(1, classes)), [0],
                                   {1: 1, 2: 2})
    return root


def write_mos_scene(root, n_frames=6, hw=MOS_HW):
    """A MOS scene: RGBA PNG colour (alpha 0, 255 and between), npy labels
    and confidences, normalised K and wxyz quaternions."""
    rng = np.random.default_rng(1)
    h, w = hw
    for sub in ("color", "detic_semantic", "detic_instance",
                "detic_probabilities", "semantic", "instance"):
        (root / sub).mkdir(parents=True)
    positions, quaternions = [], []
    for i in range(n_frames):
        angle = 2 * np.pi * i / n_frames
        positions.append([3 * np.cos(angle), 3 * np.sin(angle), 1.5])
        half = angle / 2
        quaternions.append([np.cos(half), 0.0, 0.0, np.sin(half)])
    meta = {"camera": {"K": [[0.9, 0, -0.5], [0, 0.9, -0.5], [0, 0, 1]],
                       "positions": positions, "quaternions": quaternions}}
    (root / "metadata.json").write_text(json.dumps(meta))
    for i in range(n_frames):
        name = f"{i:04d}"
        rgba = np.concatenate([rng.integers(0, 256, (h, w, 3)),
                               rng.choice([0, 255, 90], (h, w, 1))], -1)
        Image.fromarray(rgba.astype(np.uint8)).save(root / "color" / f"{name}.png")
        sem = rng.integers(0, 2, (h, w)).astype(np.int64)
        inst = rng.integers(0, 30, (h, w)).astype(np.int64)
        np.save(root / "detic_semantic" / f"{name}.npy", sem)
        np.save(root / "detic_instance" / f"{name}.npy", inst)
        np.save(root / "detic_probabilities" / f"{name}.npy",
                rng.uniform(0.2, 1, (h, w)).astype(np.float32))
        np.save(root / "semantic" / f"{name}.npy", sem)
        np.save(root / "instance" / f"{name}.npy", inst)
    return root


def assert_frames_match(jf, tf):
    assert jf.name == tf.name
    for key in EXACT:
        a, b = getattr(jf, key), getattr(tf, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                          err_msg=key)
    for key in CLOSE:
        a, b = getattr(jf, key), getattr(tf, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=key)
    np.testing.assert_allclose(tf.rgbs, jf.rgbs, atol=1 / 255 + 1e-7, rtol=0)


def assert_scenes_match(js, ts):
    assert len(js.train_frames) == len(ts.train_frames)
    assert len(js.val_frames) == len(ts.val_frames)
    for jf, tf in zip(js.train_frames + js.val_frames,
                      ts.train_frames + ts.val_frames):
        assert_frames_match(jf, tf)
    assert vars(js.segmentation) == vars(ts.segmentation)
    assert (js.things_filtered, js.stuff_filtered, js.faulty_classes) == (
        ts.things_filtered, ts.stuff_filtered, ts.faulty_classes)
    assert tuple(js.image_dim) == tuple(ts.image_dim)


@pytest.mark.parametrize("hw", [PANOPLI_HW, (16, 20)])
@pytest.mark.parametrize("labels", ["m2f", "m2f_notta", "rs"])
def test_panopli_reader_matches_jax(tmp_path, hw, labels):
    """Both readers on one SceneWriter scene, at its size and resized."""
    root = write_panopli_scene(tmp_path / "scene", notta=labels == "m2f_notta")
    kw = dict(load_feat=True)
    if labels == "rs":
        kw.update(semantics_dir="rs_semantics", instance_dir="rs_instance",
                  instance_to_semantic_key="rs_instance_to_semantic")
    elif labels == "m2f_notta":
        kw.update(semantics_dir="m2f_notta_semantics",
                  instance_dir="m2f_instance")
        (root / "m2f_notta_semantics").symlink_to(root / "m2f_semantics")
    jr, tr = JPanopLi(root, hw, 4.0, **kw), TPanopLi(root, hw, 4.0, **kw)
    assert (jr.train_indices, jr.val_indices) == (tr.train_indices,
                                                  tr.val_indices)
    np.testing.assert_array_equal(tr.intrinsics, jr.intrinsics)
    np.testing.assert_allclose(tr.scene2normscene, jr.scene2normscene,
                               atol=1e-6, rtol=0)
    js, ts = jr.load_scene(), tr.load_scene()
    assert_scenes_match(js, ts)
    # the invalid masks are real: some pixels of every frame are dropped
    assert all(not f.mask.all() for f in ts.train_frames)


@pytest.mark.parametrize("hw", [MOS_HW, (16, 16)])
@pytest.mark.parametrize("gt", [False, True])
def test_mos_reader_matches_jax(tmp_path, hw, gt):
    root = write_mos_scene(tmp_path / "scene")
    kw = (dict(semantics_dir="semantic", instance_dir="instance") if gt
          else {})
    jr, tr = JMOS(root, hw, 8.0, **kw), TMOS(root, hw, 8.0, **kw)
    assert (jr.train_indices, jr.val_indices) == (tr.train_indices,
                                                  tr.val_indices)
    np.testing.assert_array_equal(tr.intrinsics, jr.intrinsics)
    assert_scenes_match(jr.load_scene(), tr.load_scene())


@pytest.mark.parametrize("kind", ["panopli", "mos"])
@pytest.mark.parametrize("use_gt_inssem", [False, True])
def test_load_scene_dispatch_matches_jax(tmp_path, kind, use_gt_inssem):
    """``data.load_scene`` of both packages on the same scene and config,
    with the subsampling and GT-label switch passed through."""
    from contrastive_lift_tpu.config import Config as JConfig
    root = (write_panopli_scene(tmp_path / "s", features=False)
            if kind == "panopli" else write_mos_scene(tmp_path / "s"))
    kw = dict(dataset_class=kind, dataset_root=str(root), image_dim=(16, 20),
              subsample_frames=2, num_workers=1)
    js = j_load_scene(JConfig(**kw), use_gt_inssem=use_gt_inssem)
    ts = t_load_scene(TConfig(**kw), use_gt_inssem=use_gt_inssem)
    assert_scenes_match(js, ts)


def test_geometry_matches_jax():
    """The scene normalisation and distance <-> depth of ``utils/
    geometry.py`` against the JAX package's, within 1e-6."""
    from contrastive_lift_tpu.utils import geometry as jgeo
    rng = np.random.default_rng(4)
    n = 6
    dims = np.tile([[30.0, 44.0]], (n, 1))
    K = np.array([[40.0, 0, 22], [0, 40.0, 15], [0, 0, 1]], np.float32)
    intr = np.tile(K, (n, 1, 1))
    c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    c2w[:, :3, 3] = rng.normal(size=(n, 3))
    np.testing.assert_allclose(
        tgeo.compute_world2normscene(dims, intr, c2w, 4.0),
        jgeo.compute_world2normscene(dims, intr, c2w, 4.0), atol=1e-6, rtol=0)
    dist = rng.uniform(0.5, 3, 30 * 44).astype(np.float32)
    depth = tgeo.distance_to_depth(K, dist, 30, 44)
    np.testing.assert_allclose(depth, np.asarray(
        jgeo.distance_to_depth(K, dist, 30, 44)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tgeo.depth_to_distance(K, depth, 30, 44), dist,
                               atol=1e-6, rtol=1e-6)


def test_numeric_stem_key_matches_jax():
    from contrastive_lift_tpu.data.preprocessing.common import (
        numeric_stem_key as jkey)
    from contrastive_lift_tpu_torch.data.common import numeric_stem_key
    stems = ["10", "2", "frame_b", "½", "0001", "frame_a", "3"]
    assert sorted(stems, key=numeric_stem_key) == sorted(stems, key=jkey)


def test_scene_writer_round_trip_uses_pickle(tmp_path):
    """The segmentation data the reader takes from segmentation_data.pkl."""
    root = write_panopli_scene(tmp_path / "s", n_frames=4, features=False)
    with open(root / "segmentation_data.pkl", "rb") as f:
        seg = pickle.load(f)
    reader = TPanopLi(root, (16, 20), 4.0)
    assert reader.segmentation.fg_classes == seg["fg_classes"]
    assert reader.segmentation.instance_to_semantics == seg[
        "m2f_instance_to_semantic"]


def test_write_mos_scene_round_trip(tmp_path):
    """``inference/fidelity.py::write_mos_scene`` (the cli_r5b phase's
    scene): the MOS reader gets back the synthetic scene's cameras (within
    1e-5, through the wxyz quaternions), intrinsics, labels and colours
    (within 1/255), and its split is the last 20% of the frames."""
    import json as _json

    from contrastive_lift_tpu_torch.data.mos import read_mos_cameras
    from contrastive_lift_tpu_torch.data.synthetic import make_synthetic_scene
    from contrastive_lift_tpu_torch.inference.fidelity import write_mos_scene
    scene = make_synthetic_scene(num_train=6, num_val=4, image_dim=(12, 16),
                                 num_thing_classes=1, seed=3)
    root = write_mos_scene(scene, tmp_path / "mos")
    frames = scene.train_frames + scene.val_frames
    K, poses = read_mos_cameras(_json.loads((root / "metadata.json")
                                            .read_text()), 12, 16)
    np.testing.assert_allclose(K, frames[0].intrinsics, atol=1e-5)
    for f, pose in zip(frames, poses):
        np.testing.assert_allclose(pose, f.cam2normscene, atol=1e-5)
    reader = TMOS(root, (12, 16), 5.0)
    assert reader.val_indices == [8, 9]
    loaded = reader.load_scene()
    for f, got in zip(frames, loaded.train_frames + loaded.val_frames):
        assert got.name == f.name
        np.testing.assert_array_equal(got.semantics, f.semantics)
        np.testing.assert_array_equal(got.instances, f.instances)
        np.testing.assert_allclose(got.rgbs, f.rgbs, atol=0.5 / 255 + 1e-6)
    for f, got in zip(frames[8:], loaded.val_frames):
        np.testing.assert_array_equal(got.gt_semantics, f.gt_semantics)
        np.testing.assert_array_equal(got.gt_instances, f.gt_instances)


@pytest.mark.parametrize("hw", [PANOPLI_HW, (16, 20)])
def test_panopli_reader_reads_rgb_coded_and_cmyk_frames(tmp_path, hw):
    """A PanopLi scene whose ``color/*.jpg`` PIL wrote RGB-coded
    (``keep_rgb``) and CMYK: both readers, at the frames' size and resized
    (the CMYK frames LANCZOS-resized as CMYK, not as premultiplied RGBA,
    then their first 3 channels), equal, rgb included."""
    root = write_panopli_scene(tmp_path / "scene", features=False)
    frames = sorted((root / "color").glob("*.jpg"))
    for i, path in enumerate(frames):
        rgb = np.asarray(Image.open(path))
        if i % 2:
            Image.fromarray(rgb).save(path, quality=90, keep_rgb=True)
        else:
            Image.fromarray(rgb).convert("CMYK").save(path, quality=90)
    assert {Image.open(p).mode for p in frames} == {"RGB", "CMYK"}
    js = JPanopLi(root, hw, 4.0).load_scene()
    ts = TPanopLi(root, hw, 4.0).load_scene()
    assert_scenes_match(js, ts)
    for jf, tf in zip(js.train_frames + js.val_frames,
                      ts.train_frames + ts.val_frames):
        np.testing.assert_array_equal(tf.rgbs, jf.rgbs)
