"""The port's preprocessing scripts against the JAX package's, on the CPU.

Each case writes one raw input (with PIL and numpy), runs the JAX script
and the port's script (``contrastive_lift_tpu_torch/data/preprocessing/``)
on it into two trees, and holds the port's tree to the JAX one at the
bars the card's phase ``preprocess_scannet`` uses
(``inference/fidelity.py::file_digest``): the file list equal; JPEG, txt,
json and obj bytes equal; PNG headers (size, bit depth, colour type) and
pixels equal; npz arrays equal; pickles' loaded objects equal, with their
Python types. The in-the-wild pinhole path is the one exception: JAX
solves the inverse distortion with XLA in float32 and the port with numpy
in float32, so the new camera matrix is held to 1e-6 relative, and the
undistorted images to at most 0.01% of pixels one level apart.
"""
import gzip
import io
import json
import pickle
import re
import shutil
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from contrastive_lift_tpu.data.preprocessing import bboxes as jbboxes  # noqa: E402
from contrastive_lift_tpu.data.preprocessing import common as jcommon  # noqa: E402
from contrastive_lift_tpu.data.preprocessing import exports as jexports  # noqa: E402
from contrastive_lift_tpu.data.preprocessing import generic as jgeneric  # noqa: E402
from contrastive_lift_tpu.data.preprocessing import hypersim as jhypersim  # noqa: E402
from contrastive_lift_tpu.data.preprocessing import itw as jitw  # noqa: E402
from contrastive_lift_tpu.data.preprocessing import m2f as jm2f  # noqa: E402
from contrastive_lift_tpu.data.preprocessing import replica as jreplica  # noqa: E402
from contrastive_lift_tpu.data.preprocessing import scannet as jscannet  # noqa: E402
from contrastive_lift_tpu.data.preprocessing import sens_reader as jsens  # noqa: E402
from contrastive_lift_tpu_torch.data.preprocessing import bboxes as tbboxes  # noqa: E402
from contrastive_lift_tpu_torch.data.preprocessing import common as tcommon  # noqa: E402
from contrastive_lift_tpu_torch.data.preprocessing import exports as texports  # noqa: E402
from contrastive_lift_tpu_torch.data.preprocessing import generic as tgeneric  # noqa: E402
from contrastive_lift_tpu_torch.data.preprocessing import hypersim as thypersim  # noqa: E402
from contrastive_lift_tpu_torch.data.preprocessing import itw as titw  # noqa: E402
from contrastive_lift_tpu_torch.data.preprocessing import m2f as tm2f  # noqa: E402
from contrastive_lift_tpu_torch.data.preprocessing import replica as treplica  # noqa: E402
from contrastive_lift_tpu_torch.data.preprocessing import scannet as tscannet  # noqa: E402
from contrastive_lift_tpu_torch.data.preprocessing import sens_reader as tsens  # noqa: E402
from contrastive_lift_tpu_torch.data.synthetic import _look_at  # noqa: E402
from contrastive_lift_tpu_torch.inference import fidelity as fid  # noqa: E402
from contrastive_lift_tpu_torch.utils.jpeg import rgb_to_ycc  # noqa: E402
from contrastive_lift_tpu_torch.utils.png import read_png  # noqa: E402
from test_torch_port_codecs import (  # noqa: E402
    JFIF_APP0, write_huffman_jpeg)

# the undistorted images' allowance on the pinhole path (see the docstring)
ITW_K_RTOL = 1e-6
ITW_OFF_BY_ONE = 1e-4


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def assert_trees_equal(port, jax_):
    """The port's tree at the JAX one's digests, file by file."""
    got, want = fid.tree_digests(port), fid.tree_digests(jax_)
    assert sorted(got) == sorted(want)
    bad = [k for k in want if got[k] != want[k]]
    assert not bad, f"{len(bad)} files differ: {bad[:8]}"
    return len(got)


def run_both(tmp_path, fn_j, fn_t, *args, out_arg=None, **kw):
    """``fn_j`` and ``fn_t`` on the same arguments, each writing to its own
    output directory (``out_arg``: the position of the output directory in
    ``args``, or None for a keyword ``output_dir``); returns (JAX result,
    port result, JAX tree, port tree)."""
    outs = tmp_path / "jax_out", tmp_path / "port_out"
    res = []
    for fn, out in zip((fn_j, fn_t), outs):
        a = list(args)
        if out_arg is None:
            res.append(fn(*a, output_dir=out, **kw))
        else:
            a.insert(out_arg, out)
            res.append(fn(*a, **kw))
    return res[0], res[1], outs[0], outs[1]


def _smooth(h, w, seed=0, noise=6.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
           + 40 * np.sin((xx + yy) / 11.0))
    img = np.stack([img, 255 - img, img * 0.5 + 64], -1)
    return np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(
        np.uint8)


def _pose(i, n):
    angle = 2 * np.pi * i / n
    return _look_at(np.array([2 * np.cos(angle), 2 * np.sin(angle), 1.0]),
                    np.zeros(3))


def _jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


# ---------------------------------------------------------------------------
# common.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hi,dtype", [(0, np.uint8), (255, np.uint8),
                                      (256, np.uint16), (65535, np.uint16)])
def test_save_id_image_width(tmp_path, hi, dtype):
    """8-bit grey up to 255, 16-bit above, as the JAX writer (PIL) picks;
    read back equal."""
    ids = np.arange(24).reshape(4, 6) * hi // 23
    tcommon.save_id_image(ids, tmp_path / "t.png")
    jcommon.save_id_image(ids, tmp_path / "j.png")
    assert read_png(tmp_path / "t.png").dtype == dtype
    np.testing.assert_array_equal(read_png(tmp_path / "t.png"), ids)
    assert (fid.file_digest(tmp_path / "t.png")
            == fid.file_digest(tmp_path / "j.png"))


@pytest.mark.parametrize("bad", [-1, 65536])
def test_save_id_image_range_error(tmp_path, bad):
    ids = np.array([[0, bad]])
    for module in (jcommon, tcommon):
        with pytest.raises(ValueError, match="outside PNG range"):
            module.save_id_image(ids, tmp_path / "x.png")


@pytest.mark.parametrize("seed", range(3))
def test_common_functions_match_jax(seed):
    """blur_score, select_keyframes, fold_semantics and renumber_instances
    on random inputs: equal results, with the same Python types."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (17, 23, 3)).astype(np.uint8)
    assert tcommon.blur_score(img) == jcommon.blur_score(img)
    assert tcommon.blur_score(img[..., 0]) == jcommon.blur_score(img[..., 0])
    scores = rng.random(11).tolist()
    for window in (1, 3, 4):
        assert (tcommon.select_keyframes(scores, window)
                == jcommon.select_keyframes(scores, window))
    labels = rng.integers(0, 400, (9, 7))
    mapping = {int(k): int(v) for k, v in zip(rng.integers(0, 500, 20),
                                              rng.integers(0, 21, 20))}
    np.testing.assert_array_equal(tcommon.fold_semantics(labels, mapping),
                                  jcommon.fold_semantics(labels, mapping))
    sems = [rng.integers(0, 5, (8, 9)) for _ in range(3)]
    insts = [rng.integers(0, 300, (8, 9)) for _ in range(3)]
    t_new, t_table = tcommon.renumber_instances(insts, sems, {1, 2, 4})
    j_new, j_table = jcommon.renumber_instances(insts, sems, {1, 2, 4})
    for a, b in zip(t_new, j_new):
        np.testing.assert_array_equal(a, b)
    assert t_table == j_table
    assert [type(v) for v in t_table.values()] == [int] * len(t_table)
    assert tcommon.numeric_stem_key("12") == jcommon.numeric_stem_key("12")


@pytest.mark.parametrize("optional", [False, True])
def test_scene_writer_matches_jax(tmp_path, optional):
    """SceneWriter with and without the optional fields (GT, segments,
    depth, invalid masks; ids past 255): the same tree, colour JPEGs and
    grey mask JPEGs byte for byte."""
    rng = np.random.default_rng(1)
    for module, out in ((jcommon, tmp_path / "jax_out"),
                        (tcommon, tmp_path / "port_out")):
        rng = np.random.default_rng(1)
        w = module.SceneWriter(out)
        for i in range(2):
            rgb = _smooth(19, 27, seed=i)
            sem = rng.integers(0, 4, (19, 27))
            inst = rng.integers(0, 300, (19, 27))
            probs = rng.dirichlet(np.ones(4), (19, 27))
            extra = dict(gt_semantics=sem, gt_instance=inst, segments=inst,
                         depth=rng.uniform(0.5, 4, (19, 27)),
                         invalid=rng.random((19, 27)) > 0.8) if optional else {}
            w.add_frame(str(i), rgb, _pose(i, 2), sem, inst, probs,
                        rng.random((19, 27)), **extra)
        w.write_intrinsics(np.eye(4) * 3)
        w.write_splits(["0"], ["1"])
        w.write_segmentation_data([2, 1], [0, 3], {0: 0, 1: 2})
    assert assert_trees_equal(tmp_path / "port_out", tmp_path / "jax_out") > 8


# ---------------------------------------------------------------------------
# sens_reader.py and scannet.py
# ---------------------------------------------------------------------------

def write_small_sens(path, n_frames=6, hw=(24, 32), depth_hw=(12, 16),
                     color="jpeg", depth="zlib_ushort", seed=0):
    """A small version-4 .sens file: colour as PIL's JPEG (quality 90) or
    PNG, depth zlib'ed or raw, shift 1000."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_frames):
        rgb = _smooth(*hw, seed=i, noise=2 + 5 * i)
        payload = _jpeg(rgb, quality=90) if color == "jpeg" else _png(rgb)
        d = rng.uniform(500, 3000, depth_hw).astype(np.uint16).tobytes()
        frames.append(tsens.SensFrame(
            _pose(i, n_frames).astype(np.float32), i, i, payload,
            zlib_compress(d) if depth == "zlib_ushort" else d))
    k = fid._intrinsic4((30.0, 31.0, hw[1] / 2, hw[0] / 2))
    header = tsens.SensHeader("fake", k, np.eye(4, dtype=np.float32), k,
                              np.eye(4, dtype=np.float32), color, depth,
                              hw[1], hw[0], depth_hw[1], depth_hw[0], 1000.0,
                              n_frames)
    return tsens.write_sens(path, header, frames)


def zlib_compress(data):
    import zlib
    return zlib.compress(data)


@pytest.mark.parametrize("depth", ["zlib_ushort", "raw_ushort"])
@pytest.mark.parametrize("color", ["jpeg", "png"])
def test_sens_reader_matches_jax(tmp_path, color, depth):
    """Headers, poses, colour (JPEG or PNG, through the port's codecs
    against PIL) and depth of every streamed frame equal to the JAX
    reader's, with a frame skip."""
    path = write_small_sens(tmp_path / "s.sens", color=color, depth=depth)
    with open(path, "rb") as f:
        th = tsens.read_header(f)
    with open(path, "rb") as f:
        jh = jsens.read_header(f)
    for field in ("sensor_name", "color_compression", "depth_compression",
                  "color_width", "color_height", "depth_width",
                  "depth_height", "depth_shift", "num_frames"):
        assert getattr(th, field) == getattr(jh, field)
    np.testing.assert_array_equal(th.intrinsic_color, jh.intrinsic_color)
    got = list(tsens.iter_frames(path, frame_skip=2, max_frames=2))
    want = list(jsens.iter_frames(path, frame_skip=2, max_frames=2))
    assert [g[0] for g in got] == [w[0] for w in want] == [0, 2]
    for (_, th_, tf), (_, jh_, jf) in zip(got, want):
        np.testing.assert_array_equal(tf.camera_to_world, jf.camera_to_world)
        np.testing.assert_array_equal(tf.color_image(), jf.color_image())
        np.testing.assert_array_equal(tf.depth_image(th_), jf.depth_image(jh_))


def _scannet_raw(root, n_frames=6, hw=(24, 32), label_hw=(24, 32),
                 image_hw=(12, 16), m2f=False, panoptic=None,
                 label_ids=(1, 2, 5, 300, 1163)):
    """A small raw ScanNet scene: .sens, labels (raw ids past 255 unless
    ``label_ids`` says otherwise), a mapping, and per-frame machine labels
    (``m2f``) or raw panoptic dumps (``panoptic``: "npz" or "ptz") at
    ``image_hw``."""
    root.mkdir(parents=True, exist_ok=True)
    sens = write_small_sens(root / "s.sens", n_frames, hw, depth_hw=image_hw)
    rng = np.random.default_rng(2)
    (root / "labels").mkdir()
    for i in range(n_frames):
        Image.fromarray(rng.choice(label_ids, label_hw).astype(
            np.uint16)).save(root / "labels" / f"{i}_sem.png")
        Image.fromarray(rng.integers(0, 400, label_hw).astype(
            np.uint16)).save(root / "labels" / f"{i}_inst.png")
    mapping = root / "mapping.tsv"
    mapping.write_text("# raw reduced\n1 1\n2 4\n5 5\n300 6\n1163 9\n")
    out = {"sens": sens, "labels": root / "labels", "mapping": mapping}
    if m2f:
        (root / "m2f").mkdir()
        for i in range(n_frames):
            np.savez(root / "m2f" / f"{i}.npz",
                     semantics=rng.integers(0, 21, image_hw),
                     instance=rng.integers(0, 9, image_hw),
                     probability=rng.dirichlet(np.ones(21), image_hw).astype(
                         np.float32),
                     confidence=rng.random(image_hw).astype(np.float32))
        out["m2f"] = root / "m2f"
    if panoptic:
        out["panoptic"] = write_dumps(root / "panoptic", range(n_frames),
                                      image_hw, panoptic)
    return out


def write_dumps(dumps, names, hw, fmt="npz", seed=3):
    """Raw panoptic dumps: segment 0 (no prediction) on a band, walls
    (stuff) and chairs and tables (things), with COCO names; the no-TTA
    mask merges segments."""
    dumps.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = hw
    for name in names:
        mask = (np.arange(h)[:, None] * 3 // h * 4
                + np.arange(w)[None] * 4 // w + 1).astype(np.int32)
        mask[:, :max(1, w // 8)] = 0
        segs = [{"id": s, "category_id": [1, 5, 6, 1][s % 4],
                 "category_name": ["wall-brick", "chair", "dining table",
                                   "not-a-coco-class"][s % 4]}
                for s in range(1, 13)]
        notta = np.where(mask > 0, (mask + 1) // 2 * 2 - 1, 0).astype(np.int32)
        arrays = dict(mask=mask, mask_notta=notta,
                      probabilities=rng.dirichlet(np.ones(21), hw).astype(
                          np.float32),
                      confidences=rng.random(hw).astype(np.float32),
                      confidences_notta=rng.random(hw).astype(np.float32))
        if fmt == "npz":
            np.savez(dumps / f"{name}.npz", segments=json.dumps(segs),
                     segments_notta=json.dumps(segs[::2]), **arrays)
        else:
            data = {k: torch.from_numpy(v) for k, v in arrays.items()}
            data.update(segments=segs, segments_notta=segs[::2])
            if fmt == "ptz":
                with gzip.open(dumps / f"{name}.ptz", "wb") as f:
                    torch.save(data, f)
            else:
                torch.save(data, dumps / f"{name}.pt")
    return dumps


SCANNET_CASES = {
    "labels_mapping": dict(labels=True, mapping=True),
    # without a mapping the raw ids are the classes (the scripts' one-hot
    # fallback needs them below 21)
    "labels_no_mapping": dict(labels=True, mapping=False,
                              label_ids=(1, 2, 5, 9, 20)),
    "no_labels": dict(labels=False, mapping=False),
    "m2f_npz": dict(labels=True, mapping=True, m2f=True),
    "panoptic_npz": dict(labels=True, mapping=True, panoptic="npz"),
    "panoptic_ptz_coco": dict(labels=True, mapping=True, panoptic="ptz",
                              coco_remap=True),
}


@pytest.mark.parametrize("case", sorted(SCANNET_CASES))
def test_preprocess_scannet_matches_jax(tmp_path, case):
    """preprocess_scannet end to end with and without GT labels and a
    label mapping, with machine labels from npz files or from raw panoptic
    dumps (npz, or ptz with the COCO remap): trees equal; LANCZOS colour
    at a non-integer ratio, NEAREST labels in mode I, depth in mode F."""
    spec = SCANNET_CASES[case]
    raw = _scannet_raw(tmp_path / "raw", m2f=spec.get("m2f", False),
                       panoptic=spec.get("panoptic"),
                       label_ids=spec.get("label_ids", (1, 2, 5, 300, 1163)))
    kw = dict(sens_path=raw["sens"],
              label_dir=raw["labels"] if spec["labels"] else None,
              m2f_dir=raw.get("m2f"),
              label_mapping=raw["mapping"] if spec["mapping"] else None,
              frame_skip=1, keyframe_window=2, image_hw=(12, 16),
              panoptic_dir=raw.get("panoptic"),
              coco_remap=spec.get("coco_remap", False))
    j, t, jout, tout = run_both(tmp_path, jscannet.preprocess_scannet,
                                tscannet.preprocess_scannet, **kw)
    assert t["frames"] == j["frames"] == 3
    assert assert_trees_equal(tout, jout) > 15


def test_scannet_tables_match_jax():
    assert tscannet.REDUCED_CLASSES == jscannet.REDUCED_CLASSES
    assert tscannet.reduced_thing_flags() == jscannet.reduced_thing_flags()
    assert tscannet.reduced_class_names() == jscannet.reduced_class_names()


# ---------------------------------------------------------------------------
# m2f.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["npz", "pt", "ptz"])
@pytest.mark.parametrize("coco_remap", [False, True])
def test_map_panoptic_outputs_matches_jax(tmp_path, fmt, coco_remap):
    """Raw dumps of each format, with the category ids or the COCO names
    (an unknown name stays void): the m2f_* trees, the pickle and the
    returned tables equal; an existing segmentation_data.pkl keeps its
    keys."""
    names = ["0", "1", "2"]
    for side in ("jax", "port"):
        scene = tmp_path / side
        write_dumps(scene / "panoptic", names, (10, 14), fmt)
        (scene / "segmentation_data.pkl").write_bytes(pickle.dumps(
            {"fg_classes": [4], "bg_classes": [0, 1]}))
    jt = jm2f.map_panoptic_outputs(tmp_path / "jax", use_coco_remap=coco_remap,
                                   frame_names=names)
    tt = tm2f.map_panoptic_outputs(tmp_path / "port",
                                   use_coco_remap=coco_remap,
                                   frame_names=names)
    assert tt == jt
    assert assert_trees_equal(tmp_path / "port", tmp_path / "jax") > 20


def test_m2f_tables_and_frames_match_jax(tmp_path):
    """The class tables from the port's copy of resources/, and the
    per-frame conversions, equal to the JAX package's."""
    assert tm2f.load_coco_to_scannet() == jm2f.load_coco_to_scannet()
    assert tm2f.load_thing_flags() == jm2f.load_thing_flags()
    assert tm2f.load_class_names() == jm2f.load_class_names()
    for name in ("scannet_reduced_to_coco.csv", "scannet_reduced_things.csv",
                 "replica_to_scannet_reduced.csv",
                 "scannet_mmdet_to_reduced.csv"):
        assert ((tm2f.RESOURCES / name).read_bytes()
                == (jm2f.RESOURCES / name).read_bytes())
    assert tm2f.RESOURCES.parent.name == "contrastive_lift_tpu_torch"
    rng = np.random.default_rng(0)
    mask = rng.integers(0, 9, (6, 7))
    segs = [{"id": s, "category_id": int(rng.integers(0, 21)),
             "category_name": "chair"} for s in range(1, 9)]
    flags = jm2f.load_thing_flags()
    for coco in (None, jm2f.load_coco_to_scannet()):
        a = tm2f.convert_panoptic_mask(mask, segs, flags, 5, {}, coco)
        b = jm2f.convert_panoptic_mask(mask, segs, flags, 5, {}, coco)
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3:] == b[3:]
    np.testing.assert_array_equal(tm2f.segment_ids_frame(mask, segs, 3)[0],
                                  jm2f.segment_ids_frame(mask, segs, 3)[0])
    write_dumps(tmp_path / "d", ["x"], (5, 6), "ptz")
    got = tm2f.load_panoptic_dump(tmp_path / "d" / "x.ptz")
    want = jm2f.load_panoptic_dump(tmp_path / "d" / "x.ptz")
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], list):
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# generic.py and replica.py
# ---------------------------------------------------------------------------

def _png_rgb16(path, rgb16):
    """A 16-bit RGB PNG (which PIL cannot write) of [h, w, 3] samples."""
    h, w = rgb16.shape[:2]
    rows = np.ascontiguousarray(rgb16.astype(">u2")).reshape(h, -1).view(
        np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _mixed_jpeg(path, rgb, i):
    """Frame ``i`` as a CMYK JPEG (PIL's, its K a strong texture, so that
    greying it without K changes its blur score), an RGB-coded one (PIL's
    ``keep_rgb``) or a 4:4:0 YCbCr one (written by hand), by ``i % 3``."""
    if i % 3 == 0:
        k = np.random.default_rng(i).integers(0, 160, rgb.shape[:2])
        cmyk = np.concatenate([255 - rgb, k[..., None].astype(np.uint8)], -1)
        Image.fromarray(cmyk, "CMYK").save(path, quality=90)
    elif i % 3 == 1:
        Image.fromarray(rgb).save(path, quality=90, keep_rgb=True)
    else:
        planes = [p.astype(np.uint8) for p in rgb_to_ycc(rgb)]
        path.write_bytes(write_huffman_jpeg(planes, [(1, 2), (1, 1), (1, 1)],
                                            markers=JFIF_APP0))


def _generic_raw(root, n=5, hw=(20, 26), wide=False, frames="png",
                 invalid=True):
    """Frames (8-bit PNG, PIL JPEG, 16-bit RGB PNG, palette PNG, or CMYK,
    RGB-coded and 4:4:0 JPEGs, by ``frames``), pose txts, a 3x3
    intrinsic, GT labels (instance ids past 255 with ``wide``), machine
    labels and invalid masks for some frames."""
    rng = np.random.default_rng(5)
    for sub in ("frames", "poses", "sem", "inst", "m2f", "invalid"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    h, w = hw
    for i in range(n):
        rgb = _smooth(h, w, seed=i)
        if frames == "jpeg":
            Image.fromarray(rgb).save(root / "frames" / f"{i}.jpg", quality=90)
        elif frames == "rgb16":
            _png_rgb16(root / "frames" / f"{i}.png", rgb.astype(np.uint16)
                       * 257 + rng.integers(0, 256, rgb.shape))
        elif frames == "palette":
            Image.fromarray(rgb).quantize(16).save(root / "frames" / f"{i}.png")
        elif frames == "mixed_jpeg":
            _mixed_jpeg(root / "frames" / f"{i}.jpg", rgb, i)
        else:
            Image.fromarray(rgb).save(root / "frames" / f"{i}.png")
        np.savetxt(root / "poses" / f"{i}.txt", _pose(i, n))
        Image.fromarray(rng.integers(0, 4, hw).astype(np.uint8)).save(
            root / "sem" / f"{i}.png")
        inst = (rng.integers(0, 300, hw) if wide else rng.integers(0, 6, hw))
        Image.fromarray(inst.astype(np.uint16 if wide else np.uint8)).save(
            root / "inst" / f"{i}.png")
        if invalid and i % 2:
            Image.fromarray((rng.random(hw) > 0.9).astype(np.uint8) * 255).save(
                root / "invalid" / f"{i}.png")
    np.savetxt(root / "K.txt", np.array([[30.0, 0, w / 2], [0, 30.0, h / 2],
                                         [0, 0, 1]]))
    return root


@pytest.mark.parametrize("case", ["resize", "no_resize", "wide_ids_jpeg",
                                  "mapping_subsample", "rgb16_frames",
                                  "palette_frames", "mixed_jpeg_frames"])
def test_preprocess_generic_matches_jax(tmp_path, case):
    """Frames and GT resized (LANCZOS, NEAREST) or kept at their size,
    instance ids past 255, JPEG frames, 16-bit RGB frames (PIL's 8-bit
    high bytes), palette frames (PIL resizes their indices NEAREST and the
    script keeps the first three columns of them), CMYK, RGB-coded and
    4:4:0 JPEG frames (a CMYK frame resized as CMYK, then its first three
    channels), invalid masks, a label mapping and a subsample: trees
    equal."""
    frames = {"wide_ids_jpeg": "jpeg", "rgb16_frames": "rgb16",
              "palette_frames": "palette",
              "mixed_jpeg_frames": "mixed_jpeg"}.get(case, "png")
    raw = _generic_raw(tmp_path / "raw", wide=case == "wide_ids_jpeg",
                       frames=frames)
    kw = dict(gt_semantics_dir=raw / "sem", gt_instance_dir=raw / "inst",
              num_classes=4, thing_classes=(1, 3),
              image_hw=None if case == "no_resize" else (13, 17),
              invalid_dir=raw / "invalid")
    if case == "mapping_subsample":
        kw.update(label_mapping={1: 2, 2: 1, 3: 3}, subsample=2,
                  num_classes=None)
    j, t, jout, tout = run_both(tmp_path, jgeneric.preprocess_generic,
                                tgeneric.preprocess_generic, raw / "frames",
                                raw / "poses", raw / "K.txt", out_arg=3, **kw)
    assert t["frames"] == j["frames"]
    assert assert_trees_equal(tout, jout) > 20


def test_preprocess_generic_machine_labels_and_json_poses(tmp_path):
    """Machine labels from npz files and the poses as one json list."""
    raw = _generic_raw(tmp_path / "raw", invalid=False)
    rng = np.random.default_rng(8)
    for i in range(5):
        np.savez(raw / "m2f" / f"{i}.npz",
                 semantics=rng.integers(0, 3, (20, 26)),
                 instance=rng.integers(0, 4, (20, 26)),
                 probability=rng.random((20, 26, 3)).astype(np.float32),
                 confidence=rng.random((20, 26)).astype(np.float32))
    (raw / "poses.json").write_text(json.dumps(
        {"poses": [_pose(i, 5).tolist() for i in range(5)]}))
    j, t, jout, tout = run_both(
        tmp_path, jgeneric.preprocess_generic, tgeneric.preprocess_generic,
        raw / "frames", raw / "poses.json", raw / "K.txt", out_arg=3,
        m2f_dir=raw / "m2f", num_classes=3, thing_classes=[2])
    assert assert_trees_equal(tout, jout) > 20


def _replica_raw(root, n=4, hw=(18, 24)):
    for sub in ("frames", "poses", "objects"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    info = {"objects": [{"id": 1, "class_name": "bed"},
                        {"id": 2, "class_name": "wall"},
                        {"id": 5, "class_name": "basket"},
                        {"id": 260, "class_name": "chair"},
                        {"id": 7, "class_name": "not-a-replica-class"}]}
    (root / "info_semantic.json").write_text(json.dumps(info))
    h, w = hw
    for i in range(n):
        Image.fromarray(_smooth(h, w, seed=i)).save(root / "frames" / f"{i}.png")
        np.savetxt(root / "poses" / f"{i}.txt", _pose(i, n))
        obj = np.zeros(hw, np.uint16)
        obj[:, : w // 2] = 2
        obj[4:12, 4:12] = 1
        obj[2:6, 14:20] = 260
        obj[12:, 16:] = 5 if i % 2 else 7
        obj[0, 0] = 999
        Image.fromarray(obj).save(root / "objects" / f"{i}.png")
    np.savetxt(root / "K.txt", np.array([[30.0, 0, w / 2], [0, 30.0, h / 2],
                                         [0, 0, 1]]))
    return root


def test_preprocess_replica_matches_jax(tmp_path):
    """Object-id renders (ids past 255, ids outside the LUT) folded through
    the csv, an object fix, then the generic script: trees equal, staged
    folders included."""
    raw = _replica_raw(tmp_path / "raw")
    fixes = {7: 5}
    args = (raw / "frames", raw / "poses", raw / "K.txt", raw / "objects",
            raw / "info_semantic.json")
    j, t, jout, tout = run_both(tmp_path, jreplica.preprocess_replica,
                                treplica.preprocess_replica, *args,
                                out_arg=5, object_fixes=fixes,
                                image_hw=(12, 16))
    assert t["frames"] == j["frames"] == 4
    assert assert_trees_equal(tout, jout) > 20
    lut_t = treplica.build_replica_label_mapping(raw / "info_semantic.json",
                                                 object_fixes=fixes)
    lut_j = jreplica.build_replica_label_mapping(raw / "info_semantic.json",
                                                 object_fixes=fixes)
    np.testing.assert_array_equal(lut_t, lut_j)
    obj = np.array([[1, 2, 260], [5, -3, 400]])
    for a, b in zip(treplica.fold_object_ids(obj, lut_t, tm2f.load_thing_flags()),
                    jreplica.fold_object_ids(obj, lut_j, jm2f.load_thing_flags())):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# itw.py
# ---------------------------------------------------------------------------

def _itw_raw(root, model, n=4, hw=(30, 40), kind="png"):
    h, w = hw
    frames = root / "frames"
    frames.mkdir(parents=True)
    tr = {"fl_x": 32.0, "fl_y": 33.0, "cx": w / 2 - 1.5, "cy": h / 2 + 0.5,
          "h": h, "w": w, "frames": []}
    if model == "fisheye":
        tr.update(camera_model="OPENCV_FISHEYE", k1=0.08, k2=-0.02, k3=0.005,
                  k4=-0.001)
    else:
        tr.update(k1=-0.12, k2=0.03, p1=0.002, p2=-0.003)
    suffix = "png" if kind == "png" else "jpg"
    for i in range(n):
        rgb = _smooth(h, w, seed=i, noise=3 + 4 * i)
        if kind == "png":
            Image.fromarray(rgb).save(frames / f"{i:04d}.png")
        else:
            _mixed_jpeg(frames / f"{i:04d}.jpg", rgb, i)
        tr["frames"].append({"file_path": f"images/{i:04d}.{suffix}",
                             "transform_matrix": _pose(i, n).tolist()})
    (root / "transforms.json").write_text(json.dumps(tr))
    return root


def _images_close(port, jax_, allow):
    """Decoded images of the two trees: equal, or (``allow``) at most that
    share of values one level apart and none further."""
    worst = 0.0
    for p in sorted(jax_.rglob("*")):
        if p.suffix not in (".png", ".jpg"):
            continue
        q = port / p.relative_to(jax_)
        a = np.asarray(Image.open(q)).astype(int)
        b = np.asarray(Image.open(p)).astype(int)
        assert a.shape == b.shape
        diff = np.abs(a - b)
        assert diff.max() <= (1 if allow else 0), p
        worst = max(worst, float((diff > 0).mean()))
    assert worst <= allow
    return worst


@pytest.mark.parametrize("model", ["pinhole", "fisheye"])
def test_estimate_new_camera_matches_jax(model):
    """The fisheye path (float64 numpy) equal; the pinhole path (float32
    Newton, XLA against numpy) within 1e-6 relative."""
    K = np.array([[90.0, 0, 61.0], [0, 92.0, 50.0], [0, 0, 1]])
    dist = ((0.08, -0.02, 0.005, -0.001) if model == "fisheye"
            else (-0.25, 0.06, 0.004, -0.006))
    got = titw.estimate_new_camera(K, dist, (96, 128), model)
    want = jitw.estimate_new_camera(K, dist, (96, 128), model)
    if model == "fisheye":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=ITW_K_RTOL, atol=0)
    img = _smooth(96, 128)
    a, va = titw.undistort_image(img, K, dist, want, model)
    b, vb = jitw.undistort_image(img, K, dist, want, model)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(va, vb)
    xd, yd = np.linspace(-0.4, 0.4, 9), np.linspace(0.3, -0.3, 9)
    for f in ("distort_pinhole", "distort_fisheye"):
        for x, y in zip(getattr(titw, f)(xd, yd, *dist),
                        getattr(jitw, f)(xd, yd, *dist)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("model", ["pinhole", "fisheye"])
def test_preprocess_itw_matches_jax(tmp_path, model):
    """transforms.json -> keyframes (PIL's grey conversion) -> undistorted
    staging -> the generic script. Fisheye (invalid masks): trees equal.
    Pinhole: the new camera matrix within 1e-6 relative, every other file
    equal, the images (staged PNGs and colour JPEGs) at most 0.01% of
    values one level apart."""
    raw = _itw_raw(tmp_path / "raw", model)
    kw = dict(num_classes=2, thing_classes=[1], keyframe_window=2,
              image_hw=(20, 28))
    j, t, jout, tout = run_both(tmp_path, jitw.preprocess_itw,
                                titw.preprocess_itw, raw / "transforms.json",
                                raw / "frames", out_arg=2, **kw)
    assert t["frames"] == j["frames"] == 2
    got, want = fid.tree_digests(tout), fid.tree_digests(jout)
    assert sorted(got) == sorted(want)
    if model == "fisheye":
        assert (tout / "undistorted" / "invalid").iterdir()
        assert assert_trees_equal(tout, jout) > 10
        return
    for name in ("undistorted/intrinsic/intrinsic_color.txt",
                 "intrinsic/intrinsic_color.txt"):
        np.testing.assert_allclose(np.loadtxt(tout / name),
                                   np.loadtxt(jout / name), rtol=ITW_K_RTOL)
    images = re.compile(r".*\.(png|jpg)$|.*intrinsic_color\.txt$")
    bad = [k for k in want if got[k] != want[k] and not images.match(k)]
    assert not bad
    _images_close(tout, jout, ITW_OFF_BY_ONE)


def test_preprocess_itw_reads_mixed_jpeg_frames(tmp_path):
    """A fisheye capture of CMYK, RGB-coded and 4:4:0 JPEG frames, keyframes
    picked by PIL's grey conversion (a CMYK frame through RGB): the same
    keyframes, trees equal."""
    raw = _itw_raw(tmp_path / "raw", "fisheye", n=6, kind="mixed_jpeg")
    assert {Image.open(p).mode for p in (raw / "frames").iterdir()} == {
        "RGB", "CMYK"}
    kw = dict(num_classes=2, thing_classes=[1], keyframe_window=2,
              image_hw=(20, 28))
    j, t, jout, tout = run_both(tmp_path, jitw.preprocess_itw,
                                titw.preprocess_itw, raw / "transforms.json",
                                raw / "frames", out_arg=2, **kw)
    assert t["frames"] == j["frames"] == 3
    assert assert_trees_equal(tout, jout) > 10
    # the CMYK frame 0 (sharpest through its K) is a keyframe
    assert (jout / "undistorted" / "color" / "0000.png").exists()


def test_read_transforms_matches_jax(tmp_path):
    raw = _itw_raw(tmp_path, "pinhole")
    t = titw.read_transforms(raw / "transforms.json")
    j = jitw.read_transforms(raw / "transforms.json")
    assert (t["dist"], t["model"], t["hw"]) == (j["dist"], j["model"], j["hw"])
    np.testing.assert_array_equal(t["K"], j["K"])
    assert sorted(t["poses"]) == sorted(j["poses"])
    for k in j["poses"]:
        np.testing.assert_array_equal(t["poses"][k], j["poses"][k])


# ---------------------------------------------------------------------------
# bboxes.py, exports.py, hypersim.py
# ---------------------------------------------------------------------------

def _bbox_inputs(root):
    names = jm2f.load_class_names()
    chair, sofa = names.index("chair"), names.index("sofa")
    annot = np.array([[0.0, 0.0, 0.0, 1.0, 2.0, 3.0, 40, 0],
                      [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 41, 1],
                      [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 99, 2],
                      [3.0, 3.0, 3.0, 1.0, 1.0, 1.0, 41, 3]], np.float32)
    np.save(root / "scene_bbox.npy", annot)
    corners = (np.array([[sx, sy, sz] for sx in (0, 2) for sy in (0, 4)
                         for sz in (0, 6)], np.float64) + [10, 10, 10])
    dets = [{"corners": corners.tolist(), "label": "chair"},
            {"corners": (corners * 2).tolist(), "label": "Sofa"},
            {"corners": corners.tolist(), "label": "picture"}]
    (root / "dets.json").write_text(json.dumps(dets))
    (root / "raw_to_reduced.json").write_text(json.dumps(
        {"40": chair, "41": 1, "50": sofa}))
    return {40: chair, 41: 1, 50: sofa}


@pytest.mark.parametrize("fix", [None, "translation", "axis_angle"])
def test_bboxes_match_jax(tmp_path, fix):
    """GT boxes (fold, fixes, thing filter) and mmdet boxes (export fixes
    by translation or axis-angle rotation, the label map) with OBJ dumps:
    the pickle and the OBJ files equal, the returned boxes equal."""
    mapping = _bbox_inputs(tmp_path)
    export_fix = {None: None, "translation": {"translation": [10, 10, 10]},
                  "axis_angle": {"rotation": [0.3, 0, 0, 1], "scale": 2.0,
                                 "translation": [1, 2, 3]}}[fix]
    results = []
    for side, module in (("jax", jbboxes), ("port", tbboxes)):
        scene = tmp_path / side
        writer = (jcommon if side == "jax" else tcommon).SceneWriter(scene)
        writer.write_segmentation_data([4, 5], [0, 1], {1: 4})
        gt = module.import_gt_bboxes(tmp_path / "scene_bbox.npy", scene,
                                     mapping, object_id_fixes={4: 50},
                                     visualize=True)
        mm = module.import_mmdet_bboxes(tmp_path / "dets.json", scene,
                                        export_fix=export_fix, visualize=True)
        results.append((gt, mm))
    assert fid._canonical(results[0]) == fid._canonical(results[1])
    assert tbboxes.load_mmdet_label_map() == jbboxes.load_mmdet_label_map()
    assert assert_trees_equal(tmp_path / "port", tmp_path / "jax") >= 4


def _export_scene(root):
    writer = jcommon.SceneWriter(root)
    rng = np.random.default_rng(11)
    for i in range(3):
        writer.add_frame(str(i), _smooth(12, 16, seed=i), _pose(i, 3),
                         rng.integers(0, 3, (12, 16)),
                         rng.integers(0, 3, (12, 16)),
                         rng.random((12, 16, 3)), rng.random((12, 16)),
                         depth=rng.uniform(0.5, 3, (12, 16)))
    writer.write_intrinsics(np.eye(4))
    writer.write_splits(["0", "1"], ["2"])
    (root / "splits.json").write_text('{"train": ["0", "1"], "val": ["2"]}')
    for sub in ("m2f_notta_semantics", "m2f_notta_instance",
                "m2f_notta_instance_correspondences"):
        (root / sub).mkdir()
        for i in range(3):
            if "semantics" in sub:
                arr = rng.integers(0, 8, (12, 16)).astype(np.uint8)
            else:
                arr = rng.integers(0, 300, (12, 16)).astype(np.uint16)
            Image.fromarray(arr).save(root / sub / f"{i}.png")


@pytest.mark.parametrize("correspondences", [False, True])
def test_exports_match_jax(tmp_path, correspondences):
    """dm-nerf combined masks and i2s tables, the Replica trajectory and
    the semantic-NeRF layout: the exported trees equal."""
    for side, module in (("jax", jexports), ("port", texports)):
        scene = tmp_path / side / "scene"
        _export_scene(scene)
        module.create_instances_for_dmnerf(scene, correspondences)
        module.write_replica_traj(scene)
        module.export_for_semantic_nerf(scene, tmp_path / side / "sn"
                                        / "Sequence_1")
    assert assert_trees_equal(tmp_path / "port", tmp_path / "jax") > 40
    rng = np.random.default_rng(0)
    sem, inst = rng.integers(0, 9, (7, 8)), rng.integers(0, 4, (7, 8))
    i2s_t, i2s_j = {}, {}
    np.testing.assert_array_equal(
        texports.dmnerf_instance_map(sem, inst, [0, 1, 2], i2s_t),
        jexports.dmnerf_instance_map(sem, inst, [0, 1, 2], i2s_j))
    assert i2s_t == i2s_j


def _hypersim_raw(scene, h5py, n=4, hw=(12, 16)):
    rng = np.random.default_rng(3)
    img_dir = scene / "images" / "scene_cam_00_final_hdf5"
    geo_dir = scene / "images" / "scene_cam_00_geometry_hdf5"
    detail = scene / "_detail" / "cam_00"
    for d in (img_dir, geo_dir, detail):
        d.mkdir(parents=True)
    h, w = hw
    for fid_ in range(n):
        with h5py.File(img_dir / f"frame.{fid_:04d}.color.hdf5", "w") as f:
            f["dataset"] = rng.uniform(0, 4, (h, w, 3)).astype(np.float32)
        sem = np.full(hw, 1, np.int16)
        sem[4:, 4:] = 5
        sem[0, 0] = -1
        inst = np.zeros(hw, np.int32)
        inst[4:, 4:] = 300 + fid_
        with h5py.File(geo_dir / f"frame.{fid_:04d}.semantic.hdf5", "w") as f:
            f["dataset"] = sem
        with h5py.File(geo_dir / f"frame.{fid_:04d}.semantic_instance.hdf5",
                       "w") as f:
            f["dataset"] = inst
    with h5py.File(detail / "camera_keyframe_positions.hdf5", "w") as f:
        f["dataset"] = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    with h5py.File(detail / "camera_keyframe_orientations.hdf5", "w") as f:
        f["dataset"] = np.stack([np.eye(3, dtype=np.float32)] * n)
    (scene / "_detail" / "metadata_scene.csv").write_text(
        "parameter_name,parameter_value\nmeters_per_asset_unit,0.5\n")
    return scene


def test_preprocess_hypersim_matches_jax(tmp_path):
    """HDF5 frames through the tonemap, poses, NYU40 things and ids past
    255: trees equal (needs h5py, which only this script imports)."""
    h5py = pytest.importorskip("h5py")
    scene = _hypersim_raw(tmp_path / "ai_001_001", h5py)
    j, t, jout, tout = run_both(tmp_path, jhypersim.preprocess_hypersim,
                                thypersim.preprocess_hypersim, scene,
                                out_arg=1, image_hw=(12, 16))
    assert t["frames"] == j["frames"] == 4
    assert assert_trees_equal(tout, jout) > 20
    hdr = np.random.default_rng(0).uniform(0, 5, (9, 11, 3))
    np.testing.assert_array_equal(thypersim._tonemap(hdr),
                                  jhypersim._tonemap(hdr))


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _cli_inputs(tmp_path, name):
    """(argv without the output, the output flag or None, where the tree
    goes) of each script's ``main`` on small inputs; the scene-editing
    CLIs (m2f, bboxes, exports) get a copy of the scene each."""
    raw = tmp_path / "raw"
    if name == "scannet":
        r = _scannet_raw(raw, panoptic="npz")
        return ["--sens_path", str(r["sens"]), "--label_dir", str(r["labels"]),
                "--label_mapping", str(r["mapping"]), "--frame_skip", "2",
                "--panoptic_dir", str(r["panoptic"])], "--output_dir"
    if name == "generic":
        r = _generic_raw(raw)
        return ["--frames_dir", str(r / "frames"), "--pose_path",
                str(r / "poses"), "--intrinsics_path", str(r / "K.txt"),
                "--gt_semantics_dir", str(r / "sem"), "--gt_instance_dir",
                str(r / "inst"), "--num_classes", "4", "--thing_classes", "1",
                "3", "--subsample", "2"], "--output_dir"
    if name == "replica":
        r = _replica_raw(raw)
        return ["--frames_dir", str(r / "frames"), "--pose_path",
                str(r / "poses"), "--intrinsics_path", str(r / "K.txt"),
                "--object_id_dir", str(r / "objects"), "--info_semantic",
                str(r / "info_semantic.json")], "--output_dir"
    if name == "itw":
        r = _itw_raw(raw, "fisheye")
        return ["--transforms", str(r / "transforms.json"), "--frames_dir",
                str(r / "frames"), "--num_classes", "2", "--thing_classes",
                "1", "--keyframe_window", "2"], "--output_dir"
    if name == "hypersim":
        h5py = pytest.importorskip("h5py")
        scene = _hypersim_raw(raw / "ai", h5py)
        return ["--scene_dir", str(scene), "--subsample", "2"], "--output_dir"
    if name == "m2f":
        write_dumps(raw / "panoptic", ["0", "1"], (8, 10))
        return ["--coco_remap"], None
    if name.startswith("bboxes"):
        raw.mkdir()
        _bbox_inputs(raw)
        jcommon.SceneWriter(raw / "scene").write_segmentation_data(
            [4], [0], {})
        if name == "bboxes_gt":
            return ["--mode", "gt", "--bbox_path", str(raw / "scene_bbox.npy"),
                    "--raw_to_reduced", str(raw / "raw_to_reduced.json"),
                    "--visualize"], "--scene_dir"
        return ["--mode", "mmdet", "--bbox_path", str(raw / "dets.json"),
                "--visualize"], "--scene_dir"
    _export_scene(raw / "scene")
    mode = name.split("_", 1)[1]
    return ["--mode", mode], "--scene_dir"


CLIS = {"scannet": (jscannet, tscannet), "generic": (jgeneric, tgeneric),
        "replica": (jreplica, treplica), "itw": (jitw, titw),
        "hypersim": (jhypersim, thypersim), "m2f": (jm2f, tm2f),
        "bboxes_gt": (jbboxes, tbboxes), "bboxes_mmdet": (jbboxes, tbboxes),
        "exports_dmnerf": (jexports, texports),
        "exports_semantic_nerf": (jexports, texports),
        "exports_traj": (jexports, texports)}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_main_matches_jax(tmp_path, capsys, name):
    """Each script's ``main(argv)`` with the same flags in both packages:
    the same trees, and the same printed summary up to the output path."""
    args, out_flag = _cli_inputs(tmp_path, name)
    printed = []
    for side, module in zip(("jax", "port"), CLIS[name]):
        if out_flag in (None, "--scene_dir"):
            src = (tmp_path / "raw" / "scene" if out_flag
                   else tmp_path / "raw")
            out = tmp_path / side
            shutil.copytree(src, out)
            argv = ([str(out)] + args if out_flag is None
                    else args + [out_flag, str(out)])
        else:
            out = tmp_path / side
            argv = args + [out_flag, str(out)]
        module.main(argv)
        printed.append(capsys.readouterr().out.replace(str(out), "OUT"))
    assert printed[1] == printed[0]
    assert assert_trees_equal(tmp_path / "port", tmp_path / "jax") >= 2


@pytest.mark.parametrize("name", ["scannet", "generic", "replica", "itw",
                                  "hypersim", "m2f", "bboxes", "exports"])
def test_cli_flags_match_jax(capsys, name):
    """``--help`` of each script lists the JAX one's options and
    positionals."""
    j = getattr(sys.modules[__name__], "j" + name)
    t = getattr(sys.modules[__name__], "t" + name)
    usages = []
    for module in (j, t):
        with pytest.raises(SystemExit):
            module.main(["--help"])
        text = capsys.readouterr().out
        usages.append((sorted(set(re.findall(r"--\w+", text))),
                       text.split("\n\n")[0].split(" ", 2)[-1]))
    assert usages[1] == usages[0]
