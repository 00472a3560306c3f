"""Training frames of the seeded room labelled as Messy Rooms labels them.

The rays, the surfaces they hit, the colours and the frame-inconsistent
segment ids are ``frames.py``'s. The labels are what the port's Messy Rooms
reader (``data/mos.py``) gives a frame: 2 classes, background 0 on the
floor, the ceiling and the walls and object 1 on every box, as one-hot
probabilities; the segmenter's confidence on objects and 1.0 on the
background (the reader forces it); box instance ids, 0 on stuff. The module
offers what the train driver reads of ``frames.py``: ``tables``,
``training_frames``, ``surface_counts`` and ``RowCheck``.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.traffic import cameras
from benchmark.traffic import frames as tf
from benchmark.traffic.frames import (N_STUFF, surface_counts,  # noqa: F401
                                      surfaces, train_poses, view)

# the confidence the Messy Rooms reader gives every background pixel
BACKGROUND_CONFIDENCE = 1.0


def tables(mix: dict, n_box: int, seed: int) -> dict:
    """The labelling of the room's surfaces, from the seed: ``colour``
    [S,3], ``cls`` [S] (0 stuff, 1 boxes) and each frame's segment
    numbering ``order`` [F,S]."""
    t = mix["train"]
    if t["classes"] != 2:
        raise ValueError(f"Messy Rooms has 2 classes, the mix {t['classes']}")
    rng = np.random.default_rng([int(seed), 0x4D455353])
    colour = rng.uniform(0.1, 0.9, (N_STUFF + n_box, 3)).astype(np.float32)
    cls = (np.arange(N_STUFF + n_box) >= N_STUFF).astype(np.int64)
    order = np.stack([rng.permutation(N_STUFF + n_box) + 1
                      for _ in range(t["frames"])])
    return {"colour": colour, "cls": cls, "order": order}


def labels(surf: torch.Tensor, cls: torch.Tensor, conf: float):
    """(class [N], one-hot probabilities [N, 2], confidence [N]) of the
    surfaces ``surf``."""
    c = cls[surf]
    probs = torch.nn.functional.one_hot(c, 2).to(torch.float32)
    confs = torch.where(surf >= N_STUFF,
                        torch.tensor(conf, dtype=torch.float32,
                                     device=surf.device),
                        BACKGROUND_CONFIDENCE)
    return c, probs, confs


def training_frames(mix: dict, boxes: dict, seed: int, device,
                    block: int = 1 << 18):
    """The mix's ``train_frames`` frames at ``train_hw``, as
    ``frames.training_frames`` gives them, with Messy Rooms' labels."""
    t = mix["train"]
    lab = tables(mix, len(boxes["lo"]), seed)
    colour = torch.as_tensor(lab["colour"], device=device)
    cls = torch.as_tensor(lab["cls"], device=device)
    all_rays = cameras.rays(view(mix), train_poses(mix, boxes, seed), device)
    out = []
    for f in range(t["frames"]):
        rays = all_rays[f]
        surf = torch.cat([surfaces(rays[i:i + block], mix["room"], boxes)
                          for i in range(0, rays.shape[0], block)])
        c, probs, confs = labels(surf, cls, t["confidence"])
        order = torch.as_tensor(lab["order"][f], device=device)
        out.append({
            "rays": rays.cpu().numpy(),
            "rgbs": colour[surf].cpu().numpy(),
            "semantics": c.to(torch.int32).cpu().numpy(),
            "probabilities": probs.cpu().numpy(),
            "confidences": confs.cpu().numpy(),
            "instances": torch.where(surf >= N_STUFF, surf - N_STUFF + 1, 0)
            .to(torch.int32).cpu().numpy(),
            "segments": order[surf].to(torch.int32).cpu().numpy(),
        })
    return out


class RowCheck(tf.RowCheck):
    """``frames.RowCheck`` with Messy Rooms' labels: each row's class,
    probabilities and confidence are those ``labels`` gives its surface.
    An instance bundle holds box pixels alone, at the objects' confidence,
    so its check is the shared one."""

    def __init__(self, mix: dict, boxes: dict, seed: int, device,
                 counts: np.ndarray):
        self.mix, self.boxes, self.device = mix, boxes, device
        self.view = view(mix)
        self.c2w = torch.as_tensor(train_poses(mix, boxes, seed), device=device)
        lab = tables(mix, len(boxes["lo"]), seed)
        self.colour = torch.as_tensor(lab["colour"], device=device)
        self.cls = torch.as_tensor(lab["cls"], device=device)
        self.counts = torch.as_tensor(counts, device=device)
        self.conf = mix["train"]["confidence"]

    def _t(self, x):
        return torch.as_tensor(x, device=self.device)

    def main(self, b: dict) -> int:
        """Each row: rgb, class, probabilities and confidence of its
        surface, mask set."""
        rays = self._t(b["rays"])
        _, ok = self.locate(rays)
        s = self.surf(rays)
        c, probs, confs = labels(s, self.cls, self.conf)
        good = (ok & (self._t(b["rgbs"]) == self.colour[s]).all(-1)
                & (self._t(b["semantics"]) == c)
                & (self._t(b["probabilities"]) == probs).all(-1)
                & (self._t(b["confidences"]) == confs)
                & self._t(b["mask"]))
        return int((~good).sum())

    def segment(self, b: dict, n_segments: int) -> int:
        """Each slot: the first rays of one frame's pixels of one surface,
        as many as it has (at most the slot's size), group id the slot, at
        its surface's confidence."""
        size = b["rays"].shape[0] // n_segments
        off = 0
        for i in range(n_segments):
            sl = slice(i * size, (i + 1) * size)
            valid = self._t(b["valid"][sl])
            k = int(valid.sum())
            if k == 0:
                off += 1
                continue
            rays = self._t(b["rays"][sl])[valid]
            frame, ok = self.locate(rays)
            s = self.surf(rays)
            confs = labels(s, self.cls, self.conf)[2]
            good = (ok & (frame == frame[0]) & (s == s[0])
                    & (self._t(b["confidences"][sl])[valid] == confs))
            off += int((~good).sum())
            off += int(not valid[:k].all() or (b["group"][sl] != i).any())
            off += int(k != min(int(self.counts[frame[0], s[0]]), size))
        return off
