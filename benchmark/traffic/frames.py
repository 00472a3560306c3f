"""Training frames of the seeded room, labelled by ray-box intersection.

Each pixel's ray is cut with the room's interior box (floor, ceiling, two
pairs of walls) and with every box; the nearest hit names the surface.
The labels are what a ScanNet frame carries after preprocessing: rgb (a
seeded colour a surface), 21-class semantics (floor 1, ceiling 2, walls
3, each box a class from 4 to 20, class 0 unused) as probabilities with
a confidence, box instance ids (0 on stuff) and frame-inconsistent segment
ids (every frame numbers the surfaces in an order of its own, as a 2D
segmenter would). Made on the device in blocks, returned as numpy arrays.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.traffic import cameras

N_STUFF = 3          # floor, ceiling, walls: classes 1-3
FIRST_BOX_CLASS = 4


def _slab(o, d, lo, hi):
    """Entry and exit distances of rays [N,3] through boxes [B,3]: [N,B]."""
    inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-12), d)
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    return (torch.minimum(t0, t1).amax(-1), torch.maximum(t0, t1).amin(-1))


def surfaces(rays: torch.Tensor, room: dict, boxes: dict) -> torch.Tensor:
    """[N] surface of each ray's first hit: 0 floor, 1 ceiling, 2 walls,
    3 + b box b."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    hx, hy = room["half_xy"]
    lo = torch.tensor([-hx, -hy, room["floor"]], device=rays.device)
    hi = torch.tensor([hx, hy, room["ceiling"]], device=rays.device)
    # the exit of the interior box: which face
    inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-12), d)
    t_face = torch.maximum((lo - o) * inv, (hi - o) * inv)        # [N,3]
    axis = torch.argmin(t_face, dim=-1)
    t_room = torch.gather(t_face, 1, axis[:, None])[:, 0]
    stuff = torch.where(axis == 2, torch.where(d[:, 2] < 0, 0, 1), 2)
    blo = torch.as_tensor(boxes["lo"], device=rays.device)
    bhi = torch.as_tensor(boxes["hi"], device=rays.device)
    t_in, t_out = _slab(o, d, blo, bhi)
    hit = (t_in <= t_out) & (t_in > 0)
    t_box = torch.where(hit, t_in, torch.inf)
    t_best, b = torch.min(t_box, dim=-1)
    return torch.where(t_best < t_room, 3 + b, stuff)


def view(mix: dict) -> dict:
    """The training frames' camera mix: ``cameras.poses`` and
    ``cameras.rays`` of ``train_frames`` frames at ``train_hw``."""
    t = mix["train"]
    return dict(mix, frames_per_call=t["frames"], height=t["hw"][0],
                width=t["hw"][1])


def train_poses(mix: dict, boxes: dict, seed: int) -> np.ndarray:
    """[frames, 4, 4] camera-to-world matrices of the training frames."""
    return cameras.poses(view(mix), boxes, seed, 1 << 20)


def tables(mix: dict, n_box: int, seed: int) -> dict:
    """The labelling of the room's surfaces, from the seed: ``colour``
    [S,3], ``cls`` [S] and each frame's segment numbering ``order`` [F,S]."""
    t = mix["train"]
    n_classes = t["classes"]
    rng = np.random.default_rng([int(seed), 0x4652414D])
    colour = rng.uniform(0.1, 0.9, (N_STUFF + n_box, 3)).astype(np.float32)
    cls = np.concatenate([
        np.arange(1, N_STUFF + 1),
        FIRST_BOX_CLASS + rng.integers(0, n_classes - FIRST_BOX_CLASS, n_box)])
    order = np.stack([rng.permutation(N_STUFF + n_box) + 1
                      for _ in range(t["frames"])])
    return {"colour": colour, "cls": cls, "order": order}


def probabilities(c: torch.Tensor, n_classes: int, conf: float):
    """[N, C] class probabilities of classes ``c`` at confidence ``conf``."""
    probs = torch.full((c.shape[0], n_classes), (1.0 - conf) / (n_classes - 1),
                       device=c.device)
    return probs.scatter_(1, c[:, None], conf)


def training_frames(mix: dict, boxes: dict, seed: int, device,
                    block: int = 1 << 18):
    """The mix's ``train_frames`` frames at ``train_hw``: a list of dicts of
    numpy arrays (rays, rgbs, semantics, probabilities, confidences,
    instances, segments), poses from ``train_poses``."""
    t = mix["train"]
    lab = tables(mix, len(boxes["lo"]), seed)
    colour = torch.as_tensor(lab["colour"], device=device)
    cls = torch.as_tensor(lab["cls"], device=device)
    all_rays = cameras.rays(view(mix), train_poses(mix, boxes, seed), device)
    conf = t["confidence"]
    out = []
    for f in range(t["frames"]):
        rays = all_rays[f]
        surf = torch.cat([surfaces(rays[i:i + block], mix["room"], boxes)
                          for i in range(0, rays.shape[0], block)])
        c = cls[surf]
        # a segmenter's own numbering of this frame's surfaces
        order = torch.as_tensor(lab["order"][f], device=device)
        out.append({
            "rays": rays.cpu().numpy(),
            "rgbs": colour[surf].cpu().numpy(),
            "semantics": c.to(torch.int32).cpu().numpy(),
            "probabilities": probabilities(c, t["classes"], conf).cpu().numpy(),
            "confidences": np.full(rays.shape[0], conf, np.float32),
            "instances": torch.where(surf >= N_STUFF, surf - N_STUFF + 1, 0)
            .to(torch.int32).cpu().numpy(),
            "segments": order[surf].to(torch.int32).cpu().numpy(),
        })
    return out


def surface_counts(frames: list, order: np.ndarray) -> np.ndarray:
    """[F, S] pixels of each surface in each frame (a frame's segment id of
    surface s is ``order[frame, s]``)."""
    return np.stack([np.bincount(f["segments"] - 1,
                                 minlength=order.shape[1])[order[i] - 1]
                     for i, f in enumerate(frames)])


class RowCheck:
    """Sampled training rows held to the frames they claim to come from.

    A row's ray has to be the ray of a pixel of a training frame: its origin
    is a frame's camera, and the pixel its direction projects to gives the
    same ray back. Its labels have to be those of the surface the ray hits
    first. Each check returns the number of rows (and bundles) that break
    this."""

    def __init__(self, mix: dict, boxes: dict, seed: int, device,
                 counts: np.ndarray):
        self.mix, self.boxes, self.device = mix, boxes, device
        self.view = view(mix)
        self.c2w = torch.as_tensor(train_poses(mix, boxes, seed), device=device)
        lab = tables(mix, len(boxes["lo"]), seed)
        self.colour = torch.as_tensor(lab["colour"], device=device)
        self.cls = torch.as_tensor(lab["cls"], device=device)
        self.counts = torch.as_tensor(counts, device=device)
        t = mix["train"]
        self.n_classes, self.conf = t["classes"], t["confidence"]

    def locate(self, rays: torch.Tensor):
        """(frame [N], ok [N]): the frame whose camera is each ray's origin,
        and whether the ray is that frame's ray of the pixel it hits."""
        o, d = rays[:, 0:3], rays[:, 3:6]
        pos = self.c2w[:, :3, 3]
        eq = (o[:, None, :] == pos[None]).all(-1)
        frame = eq.to(torch.int64).argmax(-1)
        m = self.c2w[frame, :3, :3]
        cam = torch.einsum("nkj,nk->nj", m, d)
        h, w = self.view["height"], self.view["width"]
        f = (w / 2) / math.tan(math.radians(self.view["hfov_deg"]) / 2)
        z = torch.where(cam[:, 2] > 0, cam[:, 2], torch.ones_like(cam[:, 2]))
        i = torch.round(cam[:, 0] / z * f + (w - 1) / 2)
        j = torch.round(cam[:, 1] / z * f + (h - 1) / 2)
        inside = (cam[:, 2] > 0) & (i >= 0) & (i < w) & (j >= 0) & (j < h)
        again = cameras.pixel_rays(self.view, m, i, j, o)
        ok = (eq.any(-1) & inside
              & ((again - rays).abs().amax(-1) <= 1e-5))
        return frame, ok

    def surf(self, rays):
        return surfaces(rays, self.mix["room"], self.boxes)

    def main(self, b: dict) -> int:
        """Each row: rgb, class, probabilities and confidence of its
        surface, mask set."""
        rays = torch.as_tensor(b["rays"], device=self.device)
        _, ok = self.locate(rays)
        s = self.surf(rays)
        c = self.cls[s]
        probs = probabilities(c, self.n_classes, self.conf)
        good = (ok
                & (torch.as_tensor(b["rgbs"], device=self.device)
                   == self.colour[s]).all(-1)
                & (torch.as_tensor(b["semantics"], device=self.device) == c)
                & (torch.as_tensor(b["probabilities"], device=self.device)
                   == probs).all(-1)
                & (torch.as_tensor(b["confidences"], device=self.device)
                   == self.conf)
                & torch.as_tensor(b["mask"], device=self.device))
        return int((~good).sum())

    def instance(self, b: dict, max_labels: int) -> int:
        """Each bundle: rays of box pixels of one frame, as many as it has
        (at most the bundle's size), labelled by the rank of their box among
        the bundle's boxes (ranks past ``max_labels`` fold into the last)."""
        off = 0
        for i in range(b["rays"].shape[0]):
            valid = torch.as_tensor(b["valid"][i], device=self.device)
            if not valid.any():
                off += 1
                continue
            rays = torch.as_tensor(b["rays"][i], device=self.device)[valid]
            labels = torch.as_tensor(b["labels"][i],
                                     device=self.device)[valid].long()
            frame, ok = self.locate(rays)
            s = self.surf(rays)
            rank = torch.unique(s, return_inverse=True)[1].clamp(
                max=max_labels - 1)
            good = (ok & (frame == frame[0]) & (s >= N_STUFF)
                    & (labels == rank)
                    & (torch.as_tensor(b["confidences"][i],
                                       device=self.device)[valid] == self.conf))
            off += int((~good).sum())
            boxes = int(self.counts[frame[0], N_STUFF:].sum())
            off += int(len(rays) != min(boxes, valid.shape[0]))
        return off

    def segment(self, b: dict, n_segments: int) -> int:
        """Each slot: the first rays of one frame's pixels of one surface,
        as many as it has (at most the slot's size), group id the slot."""
        size = b["rays"].shape[0] // n_segments
        off = 0
        for i in range(n_segments):
            sl = slice(i * size, (i + 1) * size)
            valid = torch.as_tensor(b["valid"][sl], device=self.device)
            k = int(valid.sum())
            if k == 0:
                off += 1
                continue
            rays = torch.as_tensor(b["rays"][sl], device=self.device)[valid]
            frame, ok = self.locate(rays)
            s = self.surf(rays)
            good = (ok & (frame == frame[0]) & (s == s[0])
                    & (torch.as_tensor(b["confidences"][sl],
                                       device=self.device)[valid] == self.conf))
            off += int((~good).sum())
            off += int(not valid[:k].all() or (b["group"][sl] != i).any())
            off += int(k != min(int(self.counts[frame[0], s[0]]), size))
        return off
