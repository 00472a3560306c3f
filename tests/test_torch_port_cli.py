"""The port's clustering variants, artifacts, evaluation and CLIs against
the JAX package, on the CPU.

- HDBSCAN (``inference/hdbscan.py``) against ``sklearn.cluster.HDBSCAN``
  with the arguments ``inference/cluster.py`` passes: labels equal up to a
  permutation of the cluster ids, noise equal.
- ``cluster(use_dbscan=True)``, ``cluster_segmentwise`` and
  ``assign_clusters`` against the JAX package's on the same features: the
  instance of every pixel equal on at least 99.9% of the pixels (both
  assign pixels to their nearest centre in float32, in different orders),
  centroids within 1e-5.
- ``render_checkpoint_outputs`` of both packages on one grid-14 checkpoint
  with float32 heads, on the production path (the CLI's defaults): npy
  files within 2e-5, the PNGs read back by PIL (``pred_surrogateid`` 16-bit)
  equal on at least 99.9% of the pixels, evaluation within 0.005; and
  ``evaluate_folders`` of both packages on the same folders equal.
- The render and evaluate CLIs of both packages on a PanopLi scene written
  by the JAX package's ``SceneWriter`` (JPEG colour), with mean-shift and
  with HDBSCAN: the same artifact tree within the same bars.
"""
import json
import pickle

import jax
import numpy as np
import pytest
from PIL import Image
from sklearn.cluster import HDBSCAN

from contrastive_lift_tpu.cli import evaluate as j_eval_cli
from contrastive_lift_tpu.cli import render as j_render_cli
from contrastive_lift_tpu.data.base import FrameData as JFrame
from contrastive_lift_tpu.inference import cluster as jcluster
from contrastive_lift_tpu.inference import evaluate as jevaluate
from contrastive_lift_tpu.inference import render as jrender
from contrastive_lift_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from contrastive_lift_tpu_torch.cli import evaluate as t_eval_cli
from contrastive_lift_tpu_torch.cli import render as t_render_cli
from contrastive_lift_tpu_torch.data.base import FrameData as TFrame
from contrastive_lift_tpu_torch.inference import cluster as tcluster
from contrastive_lift_tpu_torch.inference import evaluate as tevaluate
from contrastive_lift_tpu_torch.inference import render as trender
from contrastive_lift_tpu_torch.inference.hdbscan import hdbscan_labels
from test_torch_port_production import _sparse_checkpoint
from test_torch_port_readers import write_panopli_scene
from test_torch_port_render import JConfig, TConfig, _cfg, _rays

jax.config.update("jax_platforms", "cpu")

NPY = ("instance_features.npy", "thing_features.npy", "slow_features.npy")
PNG_DIRS = ("pred_semantics", "pred_surrogateid")
METRICS = ("iou", "pq", "sq", "rq")
# the CLI scene: SceneWriter frames of this size, rendered at it
SCENE_HW = (24, 32)


def same_up_to_permutation(a, b) -> bool:
    """Whether labels ``a`` and ``b`` agree up to renaming the clusters,
    with -1 (noise) kept."""
    a, b = np.asarray(a), np.asarray(b)
    if not np.array_equal(a == -1, b == -1):
        return False
    pairs = set(zip(a[a != -1].tolist(), b[b != -1].tolist()))
    return (len(pairs) == len({p[0] for p in pairs})
            == len({p[1] for p in pairs}))


def _blobs(seed, n_blobs, noise_points, duplicates=0, decimals=None):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1, (n_blobs, 3))
    pts = [c + rng.normal(0, rng.uniform(0.01, 0.08), (rng.integers(40, 300), 3))
           for c in centers]
    pts.append(rng.uniform(0, 1, (noise_points, 3)))
    pts = np.concatenate(pts).astype(np.float32)
    if duplicates:
        pts = np.concatenate([pts, pts[:duplicates]])
    if decimals is not None:
        pts = np.round(pts, decimals)
    return pts


HDBSCAN_CASES = {
    "blobs_noise": (dict(seed=0, n_blobs=4, noise_points=80), 15),
    "blobs_small_clusters": (dict(seed=1, n_blobs=5, noise_points=40), 5),
    "duplicates": (dict(seed=2, n_blobs=3, noise_points=30, duplicates=25), 15),
    "ties": (dict(seed=3, n_blobs=3, noise_points=50, decimals=2), 10),
    "single_cluster": (dict(seed=4, n_blobs=1, noise_points=0), 100),
    "one_cluster_of_many": (dict(seed=5, n_blobs=3, noise_points=20), 400),
}


@pytest.mark.parametrize("case", sorted(HDBSCAN_CASES))
def test_hdbscan_matches_sklearn(case):
    kw, min_cluster_size = HDBSCAN_CASES[case]
    pts = _blobs(**kw)
    want = HDBSCAN(min_cluster_size=min_cluster_size, min_samples=1,
                   allow_single_cluster=True, copy=True).fit(pts).labels_
    got = hdbscan_labels(pts, min_cluster_size, device="cpu")
    assert same_up_to_permutation(got, want)
    if case == "single_cluster":
        assert set(want.tolist()) <= {-1, 0} and (want == 0).any()


def _features(seed, n_images=2, per_image=900):
    """Thing features of two thing classes and stuff, and the semantics."""
    rng = np.random.default_rng(seed)
    n = n_images * per_image
    sem_labels = rng.choice([0, 1, 2], n, p=[0.2, 0.5, 0.3])
    centers = rng.uniform(-1, 1, (6, 3))
    inst = (centers[rng.integers(0, 3, n) + 3 * (sem_labels == 2)]
            + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    semantics = np.eye(3, dtype=np.float32)[sem_labels]
    semantics += rng.uniform(0, 0.1, semantics.shape).astype(np.float32)
    tf = jcluster.create_instances_from_semantics(inst, semantics, [1, 2])
    np.testing.assert_array_equal(
        tcluster.create_instances_from_semantics(inst, semantics, [1, 2]), tf)
    return tf, semantics, n_images


def _assert_onehot_close(got, want):
    assert got.shape == want.shape
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.999, agree


def test_cluster_dbscan_matches_jax():
    tf, _, n_images = _features(0)
    want = jcluster.cluster(tf, 0.15, n_images, use_dbscan=True,
                            cluster_size=50)
    got = tcluster.cluster(tf, 0.15, n_images, use_dbscan=True,
                           cluster_size=50, device="cpu")
    assert want.shape[-1] > 2
    _assert_onehot_close(got, want)


@pytest.mark.parametrize("use_dbscan", [False, True])
def test_cluster_segmentwise_matches_jax(use_dbscan):
    tf, sem, n_images = _features(1)
    want, want_c = jcluster.cluster_segmentwise(
        tf, sem, 0.15, n_images, use_dbscan=use_dbscan, cluster_size=40)
    got, got_c = tcluster.cluster_segmentwise(
        tf, sem, 0.15, n_images, use_dbscan=use_dbscan, cluster_size=40,
        device="cpu")
    _assert_onehot_close(got, want)
    assert sorted(got_c) == sorted(want_c) == [1, 2]
    for cls in want_c:
        np.testing.assert_allclose(got_c[cls], want_c[cls], atol=1e-5)


def test_assign_clusters_matches_jax():
    tf, sem, n_images = _features(2)
    _, centroids = jcluster.cluster_segmentwise(tf, sem, 0.15, n_images)
    centroids = {1: centroids[1]}      # class 2 has none: its pixels are noise
    want = jcluster.assign_clusters(tf, sem, centroids, n_images)
    got = tcluster.assign_clusters(tf, sem, centroids, n_images,
                                   device="cpu")
    _assert_onehot_close(got, want)


def _mixed_checkpoint(path):
    """``_sparse_checkpoint``'s field with a semantic head whose two logits
    are opposite, so that both classes, and thing pixels to cluster, show
    up in a render."""
    _sparse_checkpoint(path, {})
    params, meta = load_checkpoint(path)
    last = params["semantic_mlp"]["layers"][-1]
    last["w"] = np.stack([last["w"][:, 0], -last["w"][:, 0]], axis=1)
    last["b"] = np.zeros_like(last["b"])
    save_checkpoint(path, params, grid_dim=tuple(meta["grid_dim"]),
                    bbox_aabb=np.asarray(meta["bbox_aabb"]), epoch=0,
                    global_step=0)
    return path


def _frames(Frame, n=2, hw=(16, 24)):
    """Frames of ``_rays`` (they cross the sparse checkpoint's slab) with a
    pinhole intrinsics for the depth panel."""
    K = np.array([[20.0, 0, hw[1] / 2], [0, 20.0, hw[0] / 2], [0, 0, 1]],
                 np.float32)
    return [Frame(f"{i:04d}", _rays(hw[0] * hw[1], 10 + i), *([None] * 6),
                  intrinsics=K) for i in range(n)]


def _write_gt(root, names, seed=0, hw=(16, 24)):
    """MOS-layout GT (npy) for the frame names: a thing region of two
    instances on a stuff background."""
    rng = np.random.default_rng(seed)
    for sub in ("semantic", "instance"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for name in names:
        sem = (rng.random(hw) > 0.5).astype(np.int64)
        inst = sem * (1 + (np.arange(hw[1])[None, :] > hw[1] // 2))
        np.save(root / "semantic" / f"{name}.npy", sem)
        np.save(root / "instance" / f"{name}.npy", inst)
    return root


def _assert_trees_match(j_out, t_out):
    """npy within 2e-5, PNGs equal on >= 99.9% of pixels as PIL reads them,
    the surrogate ids 16-bit, a visualisation per frame."""
    for name in NPY:
        a, b = np.load(j_out / name), np.load(t_out / name)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, atol=2e-5, rtol=0, err_msg=name)
    for sub in PNG_DIRS:
        names = sorted(p.name for p in (j_out / sub).iterdir())
        assert names == sorted(p.name for p in (t_out / sub).iterdir())
        for name in names:
            ja, ta = Image.open(j_out / sub / name), Image.open(t_out / sub / name)
            assert ta.mode == ja.mode == ("L" if sub == "pred_semantics"
                                          else "I;16")
            agree = (np.array(ta) == np.array(ja)).mean()
            assert agree >= 0.999, (sub, name, agree)
    vis = sorted(p.name for p in (t_out / "vis_semantics_and_surrogate").iterdir())
    assert vis == sorted(p.name for p in (j_out / "vis_semantics_and_surrogate")
                         .iterdir())


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Both packages' render_checkpoint_outputs of the sparse grid-14
    checkpoint (float32 heads, head_topk "auto", two frames), with MOS GT
    for evaluation."""
    tmp = tmp_path_factory.mktemp("artifacts")
    ckpt = _mixed_checkpoint(tmp / "field.npz")
    out = {}
    for pkg, Config, render, Frame, kw in (
            ("jax", JConfig, jrender, JFrame, {}),
            ("torch", TConfig, trender, TFrame, {"device": "cpu"})):
        cfg = _cfg(Config)
        model = render.load_model_for_inference(ckpt, cfg, 2, **kw)[:4]
        out[pkg] = render.render_checkpoint_outputs(
            *model, cfg, _frames(Frame), [1], tmp / pkg, chunk=256,
            bandwidth=0.15, **kw)
    _write_gt(tmp / "gt", [f"{i:04d}" for i in range(2)])
    return tmp, out


def test_render_checkpoint_outputs_matches_jax(artifacts):
    tmp, summaries = artifacts
    _assert_trees_match(tmp / "jax", tmp / "torch")
    for pkg in ("jax", "torch"):
        s = summaries[pkg]
        assert s["num_frames"] == 2 and s["output_dir"] == str(tmp / pkg)
        assert s["render_seconds"] > 0 and s["rays_per_second"] > 0
    # the thing pixels were clustered into at least one instance
    assert np.array(Image.open(tmp / "torch" / "pred_surrogateid"
                               / "0000.png")).max() >= 1


def test_evaluate_folders_matches_jax(artifacts):
    """Both packages' evaluate_folders on the same prediction folder give
    the same scores; on their own predictions, within 0.005."""
    tmp, _ = artifacts
    kw = dict(things={1}, stuff={0}, image_size=(16, 24))
    same = [pkg.evaluate_folders(tmp / "jax", tmp / "gt", **kw)
            for pkg in (jevaluate, tevaluate)]
    assert same[0] == same[1]
    own = tevaluate.evaluate_folders(tmp / "torch", tmp / "gt", **kw)
    for key in METRICS:
        assert abs(own[key] - same[0][key]) <= 0.005, key
    # resized on load: NEAREST from the 16x24 PNGs and npys to another size
    resized = [pkg.evaluate_folders(tmp / "jax", tmp / "gt", things={1},
                                    stuff={0}, image_size=(11, 37))
               for pkg in (jevaluate, tevaluate)]
    assert resized[0] == resized[1]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A run directory (config.json + checkpoints/final.npz) whose config
    points at a SceneWriter scene of two classes."""
    tmp = tmp_path_factory.mktemp("cli")
    scene = write_panopli_scene(tmp / "scene", n_frames=5, hw=SCENE_HW,
                                classes=2, features=False)
    run = tmp / "run"
    (run / "checkpoints").mkdir(parents=True)
    _mixed_checkpoint(run / "checkpoints" / "final.npz")
    cfg = _cfg(JConfig, dataset_class="panopli", dataset_root=str(scene),
               max_depth=4.0)
    cfg.save(run / "config.json")
    return tmp, scene, run / "checkpoints" / "final.npz"


@pytest.mark.parametrize("clustering", ["meanshift", "dbscan"])
def test_render_and_evaluate_clis_match_jax(cli_run, clustering):
    tmp, scene, ckpt = cli_run
    args = ["--ckpt_path", str(ckpt), "--image_dim", *map(str, SCENE_HW),
            "--chunk", "256"]
    if clustering == "dbscan":
        args += ["--use_dbscan", "--cluster_size", "20"]
    j_out, t_out = tmp / f"jax_{clustering}", tmp / f"torch_{clustering}"
    j_render_cli.main(args + ["--output_dir", str(j_out)])
    summary = t_render_cli.main(args + ["--output_dir", str(t_out),
                                        "--device", "cpu"])
    assert summary["num_frames"] == 2
    _assert_trees_match(j_out, t_out)
    scores = []
    for cli, out in ((j_eval_cli, j_out), (t_eval_cli, t_out)):
        cli.main(["--root_path", str(scene), "--exp_path", str(out),
                  "--image_size", *map(str, SCENE_HW)])
        text = (out / "metrics.txt").read_text().splitlines()
        scores.append({k: float(v) for k, v in
                       (line.split(": ") for line in text)})
    assert list(scores[1]) == list(scores[0]) == ["iou", "pq", "sq", "rq"]
    for key in scores[0]:
        assert abs(scores[1][key] - scores[0][key]) <= 0.005, key
    # the port's evaluate CLI on the JAX render: the same numbers exactly
    t_eval_cli.main(["--root_path", str(scene), "--exp_path", str(j_out),
                     "--image_size", *map(str, SCENE_HW)])
    assert {k: float(v) for k, v in (line.split(": ") for line in (
        j_out / "metrics.txt").read_text().splitlines())} == scores[0]


def test_render_cli_output_dir_and_options(cli_run, monkeypatch):
    """Without --output_dir the port writes where the JAX CLI does; the
    unported --n_data_shards values raise naming the queue item."""
    tmp, scene, ckpt = cli_run
    monkeypatch.chdir(tmp)
    base = ["--ckpt_path", str(ckpt), "--image_dim", *map(str, SCENE_HW),
            "--device", "cpu", "--chunk", "256"]
    t_render_cli.main(base + ["--segmentwise", "--head-topk", "none"])
    assert (tmp / "runs" / f"scene_test_{JConfig().experiment}_seg"
            / "instance_features.npy").exists()
    with pytest.raises(NotImplementedError, match="item 12"):
        t_render_cli.main(base + ["--n_data_shards", "2"])
    assert [t_render_cli.parse_head_topk(v) for v in
            ("auto", "none", "0", "12")] == ["auto", None, None, 12]


def test_head_topk_none_renders_dense_heads(cli_run):
    """``head_topk=None`` renders the heads densely even where the config
    asks for train-time top-k (the JAX package brings head_topk_train
    back there)."""
    _, _, ckpt = cli_run
    cfg = _cfg(TConfig, head_topk_train=4)
    rcfg = trender.load_model_for_inference(ckpt, cfg, 2, head_topk=None,
                                            device="cpu")[2]
    assert rcfg.head_topk is None


def test_render_cli_defaults_to_the_card(cli_run):
    """Without --device the CLI asks for cuda, and raises without a card."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the CPU-only behaviour is not shown")
    _, _, ckpt = cli_run
    with pytest.raises(RuntimeError, match="cuda"):
        t_render_cli.main(["--ckpt_path", str(ckpt)])


def test_evaluate_cli_reads_segmentation_pickle(tmp_path):
    """Things and stuff from segmentation_data.pkl (class 0 dropped), the
    PanopLi layout, metrics.txt written; as the JAX CLI."""
    scene = write_panopli_scene(tmp_path / "scene", n_frames=4,
                                features=False)
    with open(scene / "segmentation_data.pkl", "rb") as f:
        assert pickle.load(f)["fg_classes"] == [1, 2, 3]
    pred = tmp_path / "pred"
    for sub, src in (("pred_semantics", "rs_semantics"),
                     ("pred_surrogateid", "rs_instance")):
        (pred / sub).mkdir(parents=True)
        for p in sorted((scene / src).iterdir())[:2]:
            (pred / sub / p.name).write_bytes(p.read_bytes())
    out = []
    for cli in (j_eval_cli, t_eval_cli):
        cli.main(["--root_path", str(scene), "--exp_path", str(pred),
                  "--image_size", "30", "44"])
        out.append((pred / "metrics.txt").read_text())
    assert out[0] == out[1]
    assert json.loads(json.dumps(out[1]))
