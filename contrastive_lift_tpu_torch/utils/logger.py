"""Experiment logging and run-directory snapshots.

The port's copy of ``contrastive_lift_tpu/utils/logger.py``:
  * ``snapshot_source``: zips the port's package source into the run dir;
  * ``JsonlLogger``: always-on metrics.jsonl, and images as PNG files
    (``utils/png.py``; the JAX package writes JPEG through PIL, which the
    card's machine does not have: same file stem, ``.png``);
  * ``TensorBoardLogger``: optional scalars and images through
    ``torch.utils.tensorboard``;
  * a wandb logger, only if the wandb package exists.
``make_logger`` falls back to the JSONL logger when tensorboard or wandb
cannot be imported.
"""
from __future__ import annotations

import json
import zipfile
from pathlib import Path

import numpy as np

PACKAGE_ROOT = Path(__file__).resolve().parents[1]


def snapshot_source(run_dir, extra_files=()) -> Path:
    """Zip the port's package source into run_dir/code.zip (reproducibility)."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    out = run_dir / "code.zip"
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
        for py in sorted(PACKAGE_ROOT.rglob("*.py")):
            zf.write(py, py.relative_to(PACKAGE_ROOT.parent))
        for path in extra_files:
            path = Path(path)
            if path.exists():
                zf.write(path, path.name)
    return out


class JsonlLogger:
    def __init__(self, run_dir):
        self.path = Path(run_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("a")

    def log(self, record: dict, step: int | None = None):
        if step is not None:
            record = {"step": step, **record}
        self._fh.write(json.dumps(record, default=float) + "\n")
        self._fh.flush()

    def log_image(self, tag: str, image01: np.ndarray, step: int):
        from .viz import save_image
        img_dir = self.path.parent / "images"
        img_dir.mkdir(exist_ok=True)
        save_image(img_dir / f"{step:06d}_{tag.replace('/', '_')}.png", image01)

    def close(self):
        self._fh.close()


class TensorBoardLogger(JsonlLogger):
    """Scalars + images to TensorBoard (torch backend) in addition to JSONL."""

    def __init__(self, run_dir):
        super().__init__(run_dir)
        from torch.utils.tensorboard import SummaryWriter
        self.writer = SummaryWriter(log_dir=str(Path(run_dir) / "tb"))

    def log(self, record: dict, step: int | None = None):
        super().log(record, step)
        if step is None:
            step = int(record.get("step", 0))
        for key, value in record.items():
            if isinstance(value, (int, float)) and key != "step":
                self.writer.add_scalar(key, value, step)

    def log_image(self, tag: str, image01: np.ndarray, step: int):
        super().log_image(tag, image01, step)
        self.writer.add_image(tag, np.clip(image01, 0, 1), step,
                              dataformats="HWC")

    def close(self):
        self.writer.close()
        super().close()


def make_logger(kind: str, run_dir):
    if kind == "tensorboard":
        try:
            return TensorBoardLogger(run_dir)
        except ImportError:
            print("[logger] tensorboard unavailable; using jsonl")
            return JsonlLogger(run_dir)
    if kind == "wandb":
        try:
            import wandb  # noqa: F401  (not baked into the image)
            return _WandbLogger(run_dir)
        except ImportError:
            print("[logger] wandb unavailable; using jsonl")
            return JsonlLogger(run_dir)
    return JsonlLogger(run_dir)


class _WandbLogger(JsonlLogger):
    def __init__(self, run_dir):
        super().__init__(run_dir)
        import wandb
        self.run = wandb.init(dir=str(run_dir), name=Path(run_dir).name)

    def log(self, record: dict, step: int | None = None):
        super().log(record, step)
        import wandb
        wandb.log({k: v for k, v in record.items()
                   if isinstance(v, (int, float))}, step=step)
