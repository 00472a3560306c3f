"""Train CLI: the port's ``contrastive_lift_tpu/cli/train.py``.

Usage:
    python -m contrastive_lift_tpu_torch.cli.train [--config path/to/config] \
        [--runs-dir runs] [--device cuda] [key=value overrides...]

The experiment directory (config.json, metrics.jsonl, code.zip, images/,
checkpoints/) has the JAX package's layout; its ``checkpoints/last.npz``
loads in either package. ``--device`` defaults to ``cuda`` and raises
without a card; ``--device cpu`` trains on the CPU.

``n_data_shards=N`` (0 = every visible card) trains on N data-parallel ranks
(``train/loop.py``). Under ``torchrun --nproc_per_node N`` each process is a
rank and rank 0 names the run; launched plainly, the CLI names the run and
spawns its N ranks itself (gloo on the CPU, NCCL on cards). Either way one
run directory is written, by rank 0.
"""
from __future__ import annotations

import argparse
import datetime
import random
import string
from pathlib import Path

from ..config import load_config, parse_cli_overrides
from ..data import load_scene
from ..parallel import launch
from ..parallel import mesh as pmesh
from ..train.loop import Trainer
from ..utils.device import resolve_device


def generate_experiment_name(name: str, cfg) -> str:
    """MMDDHHMM_name_scene_experiment_randomsuffix."""
    stamp = datetime.datetime.now().strftime("%m%d%H%M")
    scene = Path(cfg.dataset_root).stem
    suffix = "".join(random.choices(string.ascii_lowercase, k=4))
    return f"{stamp}_{name}_{scene}_{cfg.experiment}_{suffix}"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--runs-dir", type=str, default="runs")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda)")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # no card: raise before any work

    cfg = load_config(args.config, parse_cli_overrides(args.overrides))
    cfg = cfg.resolve_epochs()
    name = {"panopli": "PanopLi", "mos": "MOS",
            "synthetic": "Synthetic"}.get(cfg.dataset_class, cfg.dataset_class)
    run_dir = Path(args.runs_dir) / generate_experiment_name(name, cfg)
    world = launch.data_shards(cfg.n_data_shards, device)
    if world > 1 and not pmesh.launched():
        return launch.spawn(train, world, (cfg, run_dir, args.device))
    if world > 1:
        # torchrun: every rank named a run; rank 0's name is the run's
        mesh = pmesh.make_mesh(world, cfg.data_axis, device=device)
        run_dir = pmesh.broadcast_object(mesh, run_dir)
    return train(cfg, run_dir, device)


def train(cfg, run_dir: Path, device) -> Path:
    """Train ``cfg`` into ``run_dir`` on ``device``, as one rank of a
    data-parallel run when ``cfg.n_data_shards`` asks for one."""
    scene = load_scene(cfg)
    trainer = Trainer(cfg, scene, run_dir, device=device)
    if trainer.writer:
        print(f"experiment: {run_dir.name}")
    if cfg.resume:
        trainer.restore(cfg.resume)
    trainer.fit()
    trainer.logger.close()
    if trainer.writer:
        print(f"done; artifacts in {run_dir}")
    return run_dir


if __name__ == "__main__":
    main()
