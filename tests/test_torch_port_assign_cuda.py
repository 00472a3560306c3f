"""One training step under the linear-assignment instance loss (Panoptic
Lifting's, a fast-only 500-channel instance head) on the card against the
same step on the CPU.

Needs a CUDA card and skips without one. The file imports no JAX, so it
runs on a GPU host that has none:

    python -m pytest --noconftest tests/test_torch_port_assign_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from test_torch_port_cuda import _cos, _to


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step's density kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def _assign_world():
    """A grid-24 linear-assignment field (the port's own init, seed 0) with
    an opaque slab, on the synthetic sphere scene, and its first batches
    and draws."""
    from contrastive_lift_tpu_torch.config import Config
    from contrastive_lift_tpu_torch.data.base import (InstanceBundleSampler,
                                                      RayPoolSampler,
                                                      SegmentBundleSampler)
    from contrastive_lift_tpu_torch.data.synthetic import make_synthetic_scene
    from contrastive_lift_tpu_torch.factory import build_model, class_weights_for
    from contrastive_lift_tpu_torch.train.step import draw_step

    scene = make_synthetic_scene(num_spheres=4, num_train=6, num_val=2,
                                 image_dim=(24, 32), seed=0)
    cfg = Config(batch_size=256, chunk=256, min_grid_dim=24, max_grid_dim=32,
                 max_instances=500, instance_loss_mode="linear_assignment",
                 max_rays_instances=128, max_labels_per_image=16,
                 batch_size_segments=4, max_rays_segments=64,
                 chunk_segment=128, seed=0, lr=2e-3, weight_class_0=1.0,
                 late_semantic_optimization=0, instance_optimization_epoch=3,
                 segment_optimization_epoch=6).resolve_epochs()
    mcfg, params, rcfg, state_r = build_model(
        cfg, scene.num_semantic_classes, scene.scene_bounds, (24, 24, 24),
        device="cpu")
    y, x = torch.meshgrid(torch.arange(24), torch.arange(24), indexing="ij")
    planes = [p * 2 for p in params["density"]["planes"]]
    lines = [line.clone() for line in params["density"]["lines"]]
    planes[0][0] = (((y - 11.5) ** 2 + (x - 11.0) ** 2) < 16).float()
    lines[0][0] = torch.where((torch.arange(24) >= 11)
                              & (torch.arange(24) <= 13), 30.0, 0.0)
    planes[0][1], lines[0][1] = 1.0, -8.0
    params["density"] = {"planes": tuple(planes), "lines": tuple(lines)}
    rng = np.random.default_rng(1)
    frames = scene.train_frames
    batches = (RayPoolSampler(frames, 2).sample(rng, 256),
               InstanceBundleSampler(frames, 128, 16).sample(rng, 1),
               SegmentBundleSampler(frames, 64).sample(rng, 4))
    draws = draw_step(torch.Generator().manual_seed(3), cfg, 256, 256,
                      (1, 128))
    return (cfg, mcfg, rcfg, state_r, params,
            class_weights_for(cfg, scene.segmentation, device="cpu"),
            batches, draws)


@pytest.mark.cuda
def test_assign_step_on_card_matches_cpu(cuda_device, monkeypatch):
    """One linear-assignment step of every phase on the card and on the CPU
    from the same parameters, batches and draws (TF32 off): the head is the
    fast one alone, 500 wide; the two solves match the labels present
    alike; metrics within rtol 2e-3, the instance loss non-zero; every
    gradient with a cosine above 0.999 per leaf."""
    from contrastive_lift_tpu_torch.losses import losses
    from contrastive_lift_tpu_torch.renderer import render as R
    from contrastive_lift_tpu_torch.train.state import init_train_state
    from contrastive_lift_tpu_torch.train.step import (StepDraws, TrainGates,
                                                       make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, mcfg, rcfg, state_r, params, weights, batches, draws = \
        _assign_world()
    assert set(params["instance_mlp"]) == {"fast"}
    assert params["instance_mlp"]["fast"]["layers"][-1]["b"].shape == (500,)
    solve, matches = losses.hungarian, []

    def kept(cost):
        matches.append(solve(cost))
        return matches[-1]
    monkeypatch.setattr(losses, "hungarian", kept)
    gates = TrainGates(semantics_on=True, instances_on=True, segments_on=True)
    out = {}
    for dev in ("cpu", cuda_device):
        p = _to(params, dev)
        sr = R.RenderState(*(t.to(dev) for t in state_r))
        d = StepDraws(R.RayDraws(*(t.to(dev) for t in draws.main)),
                      draws.seg_jitter.to(dev), draws.inst_jitter.to(dev))
        step = make_train_step(cfg, mcfg, rcfg, gates, weights.to(dev), p,
                               aux_head_topk=32, keep_grads=True)
        _, metrics = step(init_train_state(cfg, p), sr, *batches, d, 0.5,
                          0.001)
        out[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                         step.grads)
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out["cpu"], out[str(cuda_device)]
    inst = batches[1]
    present = np.unique(inst["labels"][0][inst["valid"][0]])
    assert len(matches) == 2
    assert np.array_equal(matches[0][present], matches[1][present])
    assert m_cpu["loss_clustering"] > 0
    for name, v in m_cpu.items():
        assert abs(m_gpu[name] - v) <= 2e-3 * abs(v) + 1e-6, name
    for phase in ("main", "inst"):
        assert g_cpu[phase]
        for path, g in g_cpu[phase].items():
            assert _cos(g_gpu[phase][path], g) > 0.999, (phase, path)
