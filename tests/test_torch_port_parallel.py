"""The port's data-parallel paths (``contrastive_lift_tpu_torch/parallel/``)
on the CPU: gloo, 2 ranks, small sizes, against the JAX package's sharded
programs on the 8-device virtual mesh of ``tests/conftest.py`` and against
the port's own single process.

Every spawned run goes through ``parallel/launch.py::spawn`` with a file
store under the test's temporary directory, one torch thread a rank and a
120 s timeout past which its workers are killed and the test fails. The
ranks run functions of the port (``parallel/dryrun.py``,
``parallel/testing.py``), so they import the port and nothing else.

Bars: batch rows, padding and chunk assignments equal; the sharded
``Trainer``'s metrics within rtol 2e-3 / atol 1e-5 of the JAX package's
sharded ``Trainer`` and of the port's one process
(``tests/test_multichip.py``'s bar), the replicas bitwise equal; each
globally normalised term of a step within rtol 1e-5 of one process, its
gradients within 1e-6; the sharded render's budgets equal and maps within
1e-6 of the unsharded one's, and within the production bars of the JAX
package's sharded render.
"""
import filecmp
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastive_lift_tpu.config import Config as JConfig
from contrastive_lift_tpu.data.synthetic import make_synthetic_scene
from contrastive_lift_tpu.inference import render as jrender
from contrastive_lift_tpu.parallel import mesh as jmesh
from contrastive_lift_tpu.train import loop as jloop
from contrastive_lift_tpu_torch.cli import render as t_render_cli
from contrastive_lift_tpu_torch.cli import train as t_train_cli
from contrastive_lift_tpu_torch.config import Config as TConfig
from contrastive_lift_tpu_torch.parallel import dryrun, launch
from contrastive_lift_tpu_torch.parallel import mesh as pmesh
from contrastive_lift_tpu_torch.parallel import testing as ptesting
from contrastive_lift_tpu_torch.train import loop as tloop
from test_torch_port_production import F32_BAR, _both_rays, _sparse_checkpoint
from test_torch_port_render import JFrame, _cfg, _rays
from test_torch_port_tools import cli_run  # noqa: F401  (fixture)
from test_torch_port_train import _jax_draws

torch.set_num_threads(2)
TIMEOUT = 120
METRIC_BAR = dict(rtol=dryrun.METRIC_RTOL, atol=dryrun.METRIC_ATOL)
TERM_RTOL = 1e-5
GRAD_ATOL = 1e-6
MAP_ATOL = 1e-6
N_STEPS = 3


def _spawn(fn, args, tmp_path, n=2):
    return launch.spawn(fn, n, args, timeout=TIMEOUT, store_dir=tmp_path,
                        threads=1)


def _rank_mesh(rank, size=2):
    """A ``Mesh`` as rank ``rank`` of ``size`` sees it, without a group:
    enough for the layout helpers, which do no collective."""
    return pmesh.Mesh(rank, size, torch.device("cpu"), "gloo", None, None)


# ---------------------------------------------------------------------------
# 1. the layout helpers against the JAX package's
# ---------------------------------------------------------------------------

def test_batch_rows_match_jax():
    """Each rank's rows of a main batch, and its whole images of an instance
    batch, are the JAX package's shard on the device of that index; the
    ranks' rows in order are the global batch."""
    rng = np.random.default_rng(0)
    main = {"rays": rng.normal(size=(64, 8)).astype(np.float32),
            "mask": rng.uniform(size=64) > 0.3}
    inst = {"rays": rng.normal(size=(4, 16, 8)).astype(np.float32),
            "labels": rng.integers(0, 8, (4, 16)).astype(np.int32)}
    jm = jmesh.make_mesh(2)
    for batch, shard in ((main, pmesh.shard_main_batch),
                         (inst, pmesh.shard_instance_batch)):
        want = (jmesh.shard_main_batch if shard is pmesh.shard_main_batch
                else jmesh.shard_instance_batch)(jm, batch)
        parts = [shard(_rank_mesh(r), batch) for r in range(2)]
        for key, value in batch.items():
            np.testing.assert_array_equal(
                np.concatenate([p[key] for p in parts]), value)
            for r, part in enumerate(parts):
                jax_rows = {s.device.id: np.asarray(s.data)
                            for s in want[key].addressable_shards}
                np.testing.assert_array_equal(part[key],
                                              jax_rows[jm.devices[r].id])
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_main_batch(_rank_mesh(0, 3), main)


@pytest.mark.parametrize("n,multiple", [(13, 8), (16, 8), (5, 2), (1, 4)])
def test_pad_batch_to_multiple_matches_jax(n, multiple):
    rng = np.random.default_rng(n)
    batch = {"x": rng.normal(size=(n, 4)), "y": rng.integers(0, 9, n),
             "z": rng.uniform(size=(n, 2, 3)) > 0.5}
    want = jmesh.pad_batch_to_multiple(batch, multiple)
    got = pmesh.pad_batch_to_multiple(batch, multiple)
    assert list(got) == list(want)
    for key in batch:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("n_chunks,size", [(8, 2), (6, 4), (1, 2), (5, 3)])
def test_group_batch_sharding_gives_each_chunk_once(n_chunks, size):
    got = [list(pmesh.group_batch_sharding(_rank_mesh(r, size), n_chunks))
           for r in range(size)]
    assert sorted(j for js in got for j in js) == list(range(n_chunks))
    assert got[0][:1] == [0] and all(js == sorted(js) for js in got)


# ---------------------------------------------------------------------------
# 2. the sharded Trainer against the JAX package's sharded Trainer
# ---------------------------------------------------------------------------

TRAINER_KW = dryrun.TRAINER_CFG  # tests/test_multichip.py's
SCENE_KW = dryrun.TRAINER_SCENE


def _slab(params: dict) -> dict:
    """JAX params (numpy) with a grid-16 field empty but for an opaque slab
    across a disk, so the heads see above-threshold samples."""
    planes = [np.array(p) * 2 for p in params["density"]["planes"]]
    lines = [np.array(line) for line in params["density"]["lines"]]
    y, x = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    planes[0][0] = ((y - 7.5) ** 2 + (x - 7.0) ** 2 < 16).astype(np.float32)
    lines[0][0] = np.where((np.arange(16) >= 7) & (np.arange(16) <= 9),
                           30.0, 0.0)
    planes[0][1], lines[0][1] = 1.0, -8.0
    params["density"] = {"planes": tuple(planes), "lines": tuple(lines)}
    return params


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """3 steps of the JAX package's Trainer with n_data_shards=2, of the
    port's on 2 gloo ranks and of the port's in one process: the same
    parameters, host batches and draws (JAX's)."""
    tmp = tmp_path_factory.mktemp("trainers")
    scene = make_synthetic_scene(**SCENE_KW)
    jcfg = JConfig(**dict(TRAINER_KW, n_data_shards=2)).resolve_epochs()
    jtr = jloop.Trainer(jcfg, scene, tmp / "jax", log_every=1)
    assert jtr.mesh is not None and jtr.mesh.size == 2
    params = _slab(jax.tree.map(np.array, jtr.state.params))
    jtr.state = jtr.state._replace(params=jmesh.replicate_tree(
        jtr.mesh, jax.tree.map(jnp.asarray, params)))
    jtr.on_epoch_start(0)
    n_chunk = min(jcfg.chunk_segment,
                  jcfg.batch_size_segments * jcfg.max_rays_segments)
    inst_shape = (jcfg.batch_size_contrastive, jcfg.max_rays_instances)
    want, draws = [], []
    for i in range(N_STEPS):
        b_main = jtr.main_sampler.sample(jtr.rng, jcfg.batch_size)
        b_inst = jtr.inst_sampler.sample(jtr.rng, jcfg.batch_size_contrastive)
        b_seg = jtr.seg_sampler.sample(jtr.rng, jcfg.batch_size_segments)
        key = jax.random.PRNGKey(i)
        jtr.state, m = jtr._step_fn(
            jtr.state, jtr.state_r, jtr._shard_batch(b_main),
            jtr._shard_batch(b_inst), jtr._shard_batch(b_seg), key, 1.0, 0.0)
        want.append({k: float(v) for k, v in m.items()})
        d = _jax_draws(key, jcfg.batch_size, n_chunk, inst_shape)
        draws.append({"main": d.main.jitter.numpy(),
                      "coin": d.main.coin.numpy(),
                      "seg": d.seg_jitter.numpy(),
                      "inst": d.inst_jitter.numpy()})
    two = _spawn(dryrun.trainer_steps,
                 (dict(TRAINER_KW, n_data_shards=2), SCENE_KW,
                  str(tmp / "port2"), "cpu", params, draws, N_STEPS), tmp)
    one = dryrun.trainer_steps(dict(TRAINER_KW, n_data_shards=1),
                               SCENE_KW, str(tmp / "port1"), "cpu", params,
                               draws, N_STEPS)
    return {"jax": want, "jax_aux_k": jtr._aux_k, "two": two, "one": one}


def _assert_metrics(got: list, want: list, what: str):
    assert len(got) == len(want) == N_STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (what, i)
        for key, value in w.items():
            np.testing.assert_allclose(g[key], value, **METRIC_BAR,
                                       err_msg=f"{what}: step {i} {key}")


def test_sharded_trainer_matches_jax_sharded_trainer(trainers):
    """Every metric of every step of the port's 2-rank Trainer is the JAX
    package's n_data_shards=2 Trainer's, and so is the head budget."""
    _assert_metrics(trainers["two"]["metrics"], trainers["jax"],
                    "port 2 ranks vs JAX 2 devices")
    assert trainers["two"]["aux_k"] == trainers["jax_aux_k"]
    assert "loss_clustering" in trainers["jax"][0]
    assert "loss_segment" in trainers["jax"][0]


def test_sharded_trainer_matches_one_process(trainers):
    _assert_metrics(trainers["two"]["metrics"], trainers["one"]["metrics"],
                    "port 2 ranks vs 1 process")
    for path, want in trainers["one"]["params"].items():
        np.testing.assert_allclose(trainers["two"]["params"][path], want,
                                   rtol=1e-4, atol=1e-6, err_msg=path)


def test_sharded_trainer_replicas_are_bitwise_equal(trainers):
    """After the steps both ranks hold the same parameter and optimizer
    bytes: the replicas have not drifted."""
    for key in ("param_digests", "opt_digests"):
        digests = trainers["two"][key]
        assert len(digests) == 2 and digests[0] == digests[1], key


# ---------------------------------------------------------------------------
# 3. the terms whose global normaliser DDP's defaults would get wrong
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def terms(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("terms")
    return {"two": _spawn(ptesting.term_steps, ("cpu",), tmp),
            "one": ptesting.term_steps("cpu")}


@pytest.mark.parametrize("case", sorted(ptesting.TERM_CASES))
def test_globally_normalised_terms_match_one_process(terms, case):
    """psnr of the global mse, TV counted once (a TV-only step), the segment
    loss over the global valid count with unequal padding, the instance
    loss with the global image index: 2 ranks against 1 process."""
    two, one = terms["two"][case], terms["one"][case]
    assert set(two["metrics"]) == set(one["metrics"])
    for key, want in one["metrics"].items():
        np.testing.assert_allclose(two["metrics"][key], want, rtol=TERM_RTOL,
                                   atol=1e-7, err_msg=f"{case} {key}")
    grads = one["grads"]
    assert max(float(np.abs(g).max()) for g in grads.values()) > 1e-5, case
    for path, want in grads.items():
        np.testing.assert_allclose(two["grads"][path], want, rtol=0,
                                   atol=GRAD_ATOL, err_msg=f"{case} {path}")
    assert len(set(two["param_digests"])) == 1


# ---------------------------------------------------------------------------
# 4. the sharded production render
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("renders")
    ckpt = str(_sparse_checkpoint(tmp / "field.npz", {}))
    rays = [_both_rays(300, 1), _rays(200, 2)]
    kw = dict(instance_loss_mode="slow_fast", use_DINO_style=True,
              max_instances=3, use_mlp_for_semantics=True,
              use_mlp_for_instances=True, semantic_weight_mode="softmax",
              image_dim=(16, 24), seed=0)
    args = (ckpt, kw, 2, rays, 128)
    return {"two": _spawn(ptesting.render_sharded, args, tmp),
            "one": ptesting.render_sharded(*args), "ckpt": ckpt, "rays": rays}


def test_sharded_render_equals_the_unsharded_render(renders):
    """Whole chunks per rank: the calibrated budgets equal (two-pass
    termination on), the maps within 1e-6, the guardrails equal."""
    two, one = renders["two"], renders["one"]
    assert two["rcfg"] == one["rcfg"]
    assert one["rcfg"]["term_first"] > 0 and not one["rcfg"]["use_l1"]
    assert (two["budget_tail"], two["head_tail"]) == (one["budget_tail"],
                                                      one["head_tail"])
    for a, b in zip(two["maps"], one["maps"]):
        for key in dryrun.MAP_KEYS:
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=MAP_ATOL,
                                       err_msg=key)


def test_sharded_render_matches_jax_sharded_render(renders):
    jp, jm, jr, js, _ = jrender.load_model_for_inference(
        renders["ckpt"], _cfg(JConfig), 2, step_ratio=0.25)
    frames = [JFrame(str(i), r, *([None] * 6))
              for i, r in enumerate(renders["rays"])]
    want = jrender.render_frames(jp, jm, jr, js, frames, chunk=128,
                                 mesh=jmesh.make_mesh(2))
    for w, g in zip(want, renders["two"]["maps"]):
        assert np.mean(np.abs(w["instances"]).sum(-1) > 0) > 0.1
        for key in dryrun.MAP_KEYS:
            np.testing.assert_allclose(g[key], w[key], **F32_BAR,
                                       err_msg=key)


def test_render_frames_refuses_an_indivisible_chunk(tmp_path):
    with pytest.raises(ValueError, match="must divide mesh size"):
        from contrastive_lift_tpu_torch.inference import render as trender
        trender.render_frames(None, None, None, None, [], chunk=129,
                              mesh=_rank_mesh(0), device="cpu")


# ---------------------------------------------------------------------------
# 5. the CLIs
# ---------------------------------------------------------------------------

TRAIN_OVERRIDES = [
    "batch_size=256", "chunk=256", "min_grid_dim=12", "max_grid_dim=12",
    "batch_size_contrastive=2", "max_rays_instances=32",
    "batch_size_segments=2", "max_rays_segments=16", "max_epoch=1",
    "late_semantic_optimization=0", "instance_optimization_epoch=0",
    "segment_optimization_epoch=0", "bbox_aabb_reset_epochs=[]",
    "grid_upscale_epochs=[]", "sanity_steps=1", "save_every_n_train_steps=0",
    "logger=none", "n_data_shards=2"]


def test_train_cli_spawns_its_ranks(cli_run, tmp_path):
    """``cli.train n_data_shards=2 --device cpu`` launched plainly spawns
    two ranks that write one run directory: one config, one log, one
    ``last.npz``."""
    _, ckpt = cli_run
    runs = tmp_path / "runs"
    run_dir = t_train_cli.main(
        ["--device", "cpu", "--runs-dir", str(runs), "--config",
         str(ckpt.parents[1] / "config.json"), *TRAIN_OVERRIDES])
    assert [p for p in runs.iterdir()] == [run_dir]
    assert sorted(p.name for p in (run_dir / "checkpoints").iterdir()) == [
        "last.npz"]
    assert json.loads((run_dir / "config.json").read_text())[
        "n_data_shards"] == 2
    records = [json.loads(line) for line in
               (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert sum("val/psnr" in r for r in records) == 1
    assert len(records) == len({json.dumps(r) for r in records})


def _tree(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def test_render_cli_sharded_writes_the_unsharded_tree(cli_run, tmp_path):
    """``cli.render --n_data_shards 2 --device cpu`` writes the same
    artifact tree as ``--n_data_shards 1``, file for file. Every process
    runs on one torch thread: with more, the first CPU render call of a
    fresh process (rank 1's first chunk) may sum in another order than
    later calls (1e-7), which a byte comparison would see."""
    _, ckpt = cli_run
    base = ["--ckpt_path", str(ckpt), "--image_dim", "24", "32", "--device",
            "cpu", "--chunk", "256"]
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for n in (1, 2):
            out[n] = tmp_path / f"shards{n}"
            summary = t_render_cli.main(base + ["--n_data_shards", str(n),
                                                "--output_dir", str(out[n])])
            assert summary["output_dir"] == str(out[n])
            assert summary["cluster_seconds"] is not None
    finally:
        torch.set_num_threads(threads)
    assert _tree(out[2]) == _tree(out[1]) and _tree(out[1])
    for rel in _tree(out[1]):
        assert filecmp.cmp(out[1] / rel, out[2] / rel, shallow=False), rel


# ---------------------------------------------------------------------------
# 6. errors
# ---------------------------------------------------------------------------

def test_trainer_refuses_indivisible_batches_and_too_many_shards(tmp_path):
    """The JAX package's checks: a batch that does not divide over the
    shards raises ValueError, and so do more shards than devices (a plain
    CPU process is one device; a launch's devices are its ranks)."""
    scene = make_synthetic_scene(**SCENE_KW)
    for kw, match in ((dict(n_data_shards=2), "only 1 devices"),
                      (dict(n_data_shards=3), "only 1 devices")):
        cfg = TConfig(**dict(TRAINER_KW, **kw)).resolve_epochs()
        with pytest.raises(ValueError, match=match):
            tloop.Trainer(cfg, scene, tmp_path / "t", device="cpu")
    for kw, match in ((dict(batch_size_contrastive=3),
                       "batch_size_contrastive"),
                      (dict(n_data_shards=3), "the launch has 2 ranks")):
        with pytest.raises(Exception, match=match):
            _spawn(dryrun.trainer_steps,
                   (dict(TRAINER_KW, **{"n_data_shards": 2, **kw}), SCENE_KW,
                    str(tmp_path / "r"), "cpu", None, None, 0), tmp_path)


def test_launch_raises_when_a_worker_raises(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: the launch stops
    both and raises (rank 1's error, or rank 0's on losing its peer, which
    ever the launcher sees first), well inside the timeout."""
    t0 = time.monotonic()
    with pytest.raises((torch.multiprocessing.ProcessRaisedException,
                        torch.multiprocessing.ProcessExitedException)):
        _spawn(ptesting.fail_on_rank, (1,), tmp_path)
    assert time.monotonic() - t0 < TIMEOUT / 2


def test_native_ray_pool_keeps_torch_threads(monkeypatch):
    """The native ray pool runs on torch's OpenMP runtime: its calls take
    the scene's ``num_workers`` threads and give torch its own count back,
    so a rank keeps the thread budget its launcher gave it."""
    from contrastive_lift_tpu_torch.data import native
    if not native.native_available():
        pytest.skip("the native ray pool does not build here")
    monkeypatch.setattr(native, "_pending_threads", None)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        native.set_num_threads(3)
        src = np.arange(40, dtype=np.float32).reshape(10, 4)
        np.testing.assert_array_equal(native.gather_rows(src, [3, 1]),
                                      src[[3, 1]])
        assert native.sample_indices(10, 5, 0).shape == (5,)
        assert torch.get_num_threads() == 1
    finally:
        torch.set_num_threads(threads)


def test_checkpoint_and_logger_write_whatever_the_launch(tmp_path,
                                                        monkeypatch):
    """Only the Trainer decides which rank writes: ``save_checkpoint``,
    ``snapshot_source`` and ``make_logger`` write in any process, whatever
    ``RANK`` says."""
    from contrastive_lift_tpu_torch.io.checkpoint import save_checkpoint
    from contrastive_lift_tpu_torch.utils.logger import (make_logger,
                                                         snapshot_source)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    save_checkpoint(tmp_path / "c.npz", {"w": torch.ones(3)}, grid_dim=(4,) * 3,
                    bbox_aabb=np.zeros((2, 3), np.float32), epoch=0,
                    global_step=0)
    assert (tmp_path / "c.npz").exists()
    assert snapshot_source(tmp_path / "run").exists()
    logger = make_logger("jsonl", tmp_path / "run")
    logger.log({"a": 1.0}, step=0)
    logger.close()
    assert (tmp_path / "run" / "metrics.jsonl").read_text().strip()


def test_data_shards_resolution():
    assert launch.data_shards(1, "cpu") == 1
    assert launch.data_shards(0, "cpu") == 1
    assert launch.data_shards(3, "cpu") == 3
    with pytest.raises(RuntimeError, match="no process group"):
        pmesh.make_mesh(2, device="cpu")


# ---------------------------------------------------------------------------
# 7. the dry run
# ---------------------------------------------------------------------------

def test_dryrun_multichip_on_two_cpu_ranks(tmp_path):
    """The production Trainer over 2 gloo ranks: one tiny epoch with a
    sharded sanity validation, another epoch, a sharded validation, and the
    sharded render of the val frames equal to the unsharded one."""
    res = dryrun.dryrun_multichip(2, device="cpu", timeout=TIMEOUT,
                                  store_dir=tmp_path)
    assert res["metrics"] and all(np.isfinite(v)
                                  for v in res["metrics"].values())
    assert "loss_clustering" in res["metrics"]
    assert set(res["val"]) >= {"psnr", "iou", "pq"}
    assert res["budgets_equal"] and res["render_max_abs_err"] <= MAP_ATOL
    assert len(set(res["param_digests"])) == 1
