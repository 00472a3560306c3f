"""Plain PyTorch reference of the contrastive-lift training step.

Imports nothing of the program. One step, as the reference trainer runs it
once every gate is open (slow-fast instance loss with DINO-style EMA,
segment grouping, probabilistic semantics):

1. main: the batch rendered densely with the step's jitter (sample i at
   t_min + (i + jitter) step, interval to the next sample, 0 for the last),
   heads at every sample whose weight exceeds the threshold (rgb through
   the appearance MLP, class probabilities through the semantic MLP with
   the weights detached), white background where the coin falls under 0.5;
   loss = MSE + plane TV (density 1e-2 x 0.1, appearance 1e-2 x 0.01) +
   distortion x lambda_dist + 0.1 x confidence-weighted CE against the
   class probabilities, + 0.1 x 1.2 x the segment-grouping loss of the
   segment batch (density without gradient, every sample's interval the
   step, the semantic head on the above-threshold samples);
2. Adam on the density, appearance and semantic parameters (grids at
   20 lr, betas 0.9 / 0.99);
3. instance: the bundle rendered with the updated density (no gradient),
   fast and slow heads, the slow-fast loss; the slow head mixed toward the
   fast one by 0.1 (one image), then Adam on the fast head (betas 0.9 /
   0.999).

A configuration with another instance loss subclasses ``Step`` and
replaces ``instance_loss``; the EMA runs only where the configuration has
a slow head (``model.instance_heads``).
"""
from __future__ import annotations

import torch

from .render import matmul_precision, mlp, n_samples, positional_encoding
from .render import step_size as ray_step
from .render import vm_terms

MAIN_GRID = ("density", "appearance")
# two group means closer than this (log-probability) tie to rounding: the
# program and the reference may break the tie apart
TIE = 1e-5
MAIN_NET = ("appearance_basis", "appearance_mlp", "semantic_mlp")


def leaves(tree, prefix=()):
    """[(path, tensor)]: dict keys sorted, sequence indices in order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        out.extend(leaves(v, prefix + (k,)))
    return out


def rebuild(tree, values: dict, prefix=()):
    """``tree`` with the leaves at the paths of ``values`` replaced."""
    if isinstance(tree, torch.Tensor):
        return values.get(prefix, tree)
    if isinstance(tree, dict):
        return {k: rebuild(v, values, prefix + (k,)) for k, v in tree.items()}
    return type(tree)(rebuild(v, values, prefix + (i,))
                      for i, v in enumerate(tree))


def _ray_start(rays, bounds):
    o, d, near, far = rays[:, 0:3], rays[:, 3:6], rays[:, 6], rays[:, 7]
    vec = torch.where(d == 0, torch.full_like(d, 1e-6), d)
    t = torch.amax(torch.minimum((bounds[1] - o) / vec,
                                 (bounds[0] - o) / vec), dim=-1)
    return o, d, torch.minimum(torch.maximum(t, near), far)


def _density(params, model, xyz, bounds):
    """softplus density [R, S] at world points [R, S, 3], 0 out of the box."""
    in_box = torch.all((xyz >= bounds[0]) & (xyz <= bounds[1]), -1)
    xyz_n = ((xyz - bounds[0]) * (2.0 / (bounds[1] - bounds[0])) - 1.0)
    raw = sum(t.sum(-1) for t in vm_terms(params["density"],
                                           xyz_n.reshape(-1, 3)))
    raw = raw.reshape(in_box.shape) + model["splus_density_shift"]
    sigma = torch.logaddexp(raw, torch.zeros_like(raw))
    return torch.where(in_box, sigma, 0.0), xyz_n


def _weights(sigma, dist, scale):
    alpha = 1.0 - torch.exp(-sigma * dist * scale)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)
    return alpha * trans[:, :-1]


def _distortion(w, m, dist):
    """Mip-NeRF 360 distortion, mean over rays, in its prefix-sum form."""
    uni = torch.mean(torch.sum(w * w * dist, -1)) / 3.0
    wm = w * m
    wc, wmc = torch.cumsum(w, -1), torch.cumsum(wm, -1)
    bi = 2.0 * torch.mean(torch.sum(wm[:, 1:] * wc[:, :-1]
                                    - w[:, 1:] * wmc[:, :-1], -1))
    return bi + uni


def _log_normalise(p):
    return torch.log(p / (p.sum(-1, keepdim=True) + 1e-8) + 1e-8)


def _ce(logits, target, class_w):
    """CE against probabilities [R, C] or labels [R], class-weighted."""
    logp = torch.log_softmax(logits, -1)
    if target.dim() == logits.dim():
        return -torch.sum(target * logp * class_w, -1)
    t = target.long()
    return -torch.gather(logp, 1, t[:, None])[:, 0] * class_w[t]


def _tv_planes(planes, scale):
    total = 0.0
    for x in planes:
        c, h, w = x.shape
        total = total + 2.0 * (
            torch.sum((x[:, 1:] - x[:, :-1]) ** 2) / (c * (h - 1) * w + 1e-4)
            + torch.sum((x[:, :, 1:] - x[:, :, :-1]) ** 2)
            / (c * h * (w - 1) + 1e-4)) * scale
    return total


def _live_heads(weight, xyz_n, thres):
    """(ray index, weight, point) of the samples above the threshold."""
    live = weight > thres
    r, s = torch.nonzero(live, as_tuple=True)
    return r, weight[r, s], xyz_n[r, s]


def _composite(n, r, w, vals):
    acc = torch.zeros(n, vals.shape[1], dtype=vals.dtype, device=vals.device)
    return acc.index_add(0, r, w[:, None] * vals)


class Step:
    """The reference step of a configuration (``configs/*.json``) and a
    train mix (``traffic/train_*.json``)."""

    def __init__(self, spec: dict, mix: dict, bounds, grid_dim, device,
                 dtype=torch.float32):
        self.model, self.spec, self.mix = spec["model"], spec, mix
        self.cfg = {**spec["config"], **mix["stage"]}
        self.dtype = dtype
        self.bounds = torch.as_tensor(bounds, dtype=dtype, device=device)
        self.step = ray_step(self.bounds, grid_dim, mix["step_ratio"])
        self.S = n_samples(bounds, grid_dim, mix["step_ratio"])
        if self.cfg.get("reweight_fg"):
            raise NotImplementedError("foreground class weights")
        # cross-entropy weights: 1, and weight_class_0 on class 0
        self.class_w = torch.ones(spec["num_semantic_classes"], dtype=dtype,
                                  device=device)
        self.class_w[0] = self.cfg["weight_class_0"]

    # -- renders -----------------------------------------------------------

    def _points(self, rays, jitter, aux: bool):
        o, d, t = _ray_start(rays, self.bounds)
        i = torch.arange(self.S, dtype=self.dtype, device=rays.device)
        if aux:   # the skipping render moves the start, then steps
            z = (t + jitter * self.step)[:, None] + i[None] * self.step
        else:
            z = t[:, None] + (i[None] + jitter[:, None]) * self.step
        return d, z, o[:, None] + d[:, None] * z[..., None]

    def aux_weights(self, params, rays, jitter, block: int = 4096):
        """Weights and points of a render without gradient to the density,
        every interval the step, in blocks of rays."""
        ws, ps = [], []
        with torch.no_grad():
            for i in range(0, rays.shape[0], block):
                _, z, xyz = self._points(rays[i:i + block],
                                         jitter[i:i + block], aux=True)
                sigma, xyz_n = _density(params, self.model, xyz, self.bounds)
                ws.append(_weights(sigma, self.step.expand_as(sigma),
                                   self.model["distance_scale"]))
                ps.append(xyz_n)
        return torch.cat(ws), torch.cat(ps)

    def main_loss(self, params, batch, jitter, coin, lambda_dist):
        m, thres = self.model, self.model["raymarch_weight_thres"]
        rays = batch["rays"]
        d, z, xyz = self._points(rays, jitter, aux=False)
        sigma, xyz_n = _density(params, m, xyz, self.bounds)
        dist = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], -1)
        mids = torch.cat([(z[:, 1:] + z[:, :-1]) / 2, z[:, -2:-1]], -1)
        w = _weights(sigma, dist, m["distance_scale"])
        r, wl, p = _live_heads(w, xyz_n, thres)
        feats = torch.cat(vm_terms(params["appearance"], p), -1)
        feats = feats @ params["appearance_basis"]["w"]
        view = d[r]
        rgb = torch.sigmoid(mlp(params["appearance_mlp"]["layers"], torch.cat(
            [feats, view, positional_encoding(feats, m["pe_feat"]),
             positional_encoding(view, m["pe_view"])], -1), self.dtype))
        sem = torch.softmax(mlp(params["semantic_mlp"]["layers"], p,
                                self.dtype), -1)
        n = rays.shape[0]
        rgb_map = _composite(n, r, wl, rgb)
        rgb_map = torch.where(coin < 0.5, rgb_map + (1.0 - w.sum(-1))[:, None],
                              rgb_map).clamp(0.0, 1.0)
        sem_map = _log_normalise(_composite(n, r, wl.detach(), sem))
        mask = batch["mask"][:, None]
        mse = torch.mean((torch.where(mask, rgb_map, 0.0)
                          - torch.where(mask, batch["rgbs"], 0.0)) ** 2)
        tv = (_tv_planes(params["density"]["planes"], 1e-2)
              * self.cfg["lambda_tv_density"]
              + _tv_planes(params["appearance"]["planes"], 1e-2)
              * self.cfg["lambda_tv_appearance"])
        dist_reg = _distortion(w, mids, dist)
        conf = torch.where(batch["mask"], batch["confidences"], 0.0)
        loss_sem = torch.mean(_ce(sem_map, batch["probabilities"],
                                  self.class_w) * conf)
        return (self.cfg["lambda_rgb"] * (mse + tv + dist_reg * lambda_dist)
                + self.cfg["lambda_semantics"] * loss_sem)

    def segment_loss(self, params, batch, jitter, flip=()):
        """The grouping loss; a group's target is the argmax of its mean
        log-probabilities, or the class ``flip`` gives for it. ``self.ties``
        collects (group, runner-up) where the two largest means lie within
        ``TIE``: there the argmax is a matter of rounding."""
        rays = batch["rays"]
        n = rays.shape[0]
        j = jitter[torch.arange(n, device=rays.device) % jitter.shape[0]]
        w, xyz_n = self.aux_weights(params, rays, j)
        r, wl, p = _live_heads(w, xyz_n, self.model["raymarch_weight_thres"])
        sem = torch.softmax(mlp(params["semantic_mlp"]["layers"], p,
                                self.dtype), -1)
        feats = _log_normalise(_composite(n, r, wl, sem))
        valid = batch["valid"].to(feats.dtype)
        g = batch["group"].long()
        k = self.cfg["batch_size_segments"]
        sums = torch.zeros(k, feats.shape[1], dtype=feats.dtype,
                           device=feats.device).index_add(
            0, g, feats * valid[:, None])
        counts = torch.zeros(k, dtype=feats.dtype,
                             device=feats.device).index_add(0, g, valid)
        means = (sums / counts.clamp(min=1.0)[:, None]).detach()
        top2 = torch.topk(means, 2, dim=-1)
        target = top2.indices[:, 0].clone()
        for j, c in dict(flip).items():
            target[j] = c
        gap = top2.values[:, 0] - top2.values[:, 1]
        self.ties = [(int(j), int(top2.indices[j, 1])) for j in
                     torch.nonzero((gap < TIE) & (counts > 0)).flatten()]
        target = target[g]
        per = _ce(feats, target, self.class_w) * batch["confidences"] * valid
        return per.sum() / valid.sum().clamp(min=1.0)

    def instance_loss(self, params, batch, jitter):
        loss = 0.0
        for k in range(batch["rays"].shape[0]):
            rays = batch["rays"][k]
            w, xyz_n = self.aux_weights(params, rays, jitter[k])
            r, wl, p = _live_heads(w, xyz_n,
                                   self.model["raymarch_weight_thres"])
            slow_w = 0.9 ** k      # image k mixes the slow head k times
            slow = {"layers": [
                {n_: slow_w * s[n_] + (1 - slow_w) * f[n_].detach()
                 for n_ in ("w", "b")}
                for s, f in zip(params["instance_mlp"]["slow"]["layers"],
                                params["instance_mlp"]["fast"]["layers"])]}
            n = rays.shape[0]
            fast = _composite(n, r, wl, mlp(
                params["instance_mlp"]["fast"]["layers"], p, self.dtype))
            slow = _composite(n, r, wl, mlp(slow["layers"], p,
                                            self.dtype)).detach()
            loss = loss + slow_fast(fast, slow, batch["labels"][k].long(),
                                    batch["confidences"][k],
                                    self.cfg["max_labels_per_image"],
                                    batch["valid"][k])
        return loss

    # -- the step ------------------------------------------------------------

    def run(self, params, adam, batches, draws, lr_scale, lambda_dist,
            tf32: bool = False, flip=()):
        """(new params, new Adam state, losses, first gradients of the
        main and instance chains) of one step."""
        with matmul_precision(tf32):
            main_paths = [p for p, _ in leaves(params)
                          if p[0] in MAIN_GRID + MAIN_NET]
            p_leaves = dict(leaves(params))
            x = {p: p_leaves[p].detach().requires_grad_(True)
                 for p in main_paths}
            pg = rebuild(params, x)
            loss_main = self.main_loss(pg, batches["main"], draws["main"],
                                       draws["coin"], lambda_dist)
            loss_seg = self.segment_loss(pg, batches["seg"], draws["seg"],
                                         flip)
            loss = loss_main + (self.cfg["lambda_semantics"]
                                * self.cfg["lambda_segment"] * loss_seg)
            g = torch.autograd.grad(loss, [x[p] for p in main_paths],
                                    allow_unused=True)
            grads = {p: (gi if gi is not None else torch.zeros_like(x[p]))
                     for p, gi in zip(main_paths, g)}
            params, adam = self._adam(params, adam, grads, "main", lr_scale)
            inst_paths = [p for p, _ in leaves(params)
                          if p[:2] == ("instance_mlp", "fast")]
            p_leaves = dict(leaves(params))
            x = {p: p_leaves[p].detach().requires_grad_(True)
                 for p in inst_paths}
            loss_inst = self.instance_loss(rebuild(params, x),
                                           batches["inst"], draws["inst"])
            g = torch.autograd.grad(loss_inst, [x[p] for p in inst_paths])
            grads_i = dict(zip(inst_paths, g))
            if "slow" in self.model["instance_heads"]:
                params = self.ema(params, inst_paths,
                                  batches["inst"]["rays"].shape[0])
            params, adam = self._adam(params, adam, grads_i, "inst", lr_scale)
        losses = {"main": float(loss.detach()),
                  "segment": float(loss_seg.detach()),
                  "instance": float(loss_inst.detach())}
        return params, adam, losses, {**grads, **grads_i}

    def ema(self, params, inst_paths, n_img: int):
        """The slow head mixed toward the fast one by 0.9 an instance image,
        before the fast head's update."""
        p_leaves = dict(leaves(params))
        m = 0.9 ** n_img
        slow = {p[:1] + ("slow",) + p[2:]: m * p_leaves[p[:1] + ("slow",)
                                                        + p[2:]]
                + (1 - m) * p_leaves[p] for p in inst_paths}
        return rebuild(params, slow)

    def _adam(self, params, adam, grads, chain, lr_scale):
        lr = self.cfg["lr"]
        b1, b2 = (0.9, 0.99) if chain == "main" else (0.9, 0.999)
        st = adam.setdefault(chain, {"t": 0, "mu": {}, "nu": {}})
        st["t"] += 1
        t = st["t"]
        new = {}
        p_leaves = dict(leaves(params))
        with torch.no_grad():
            for p, g in grads.items():
                mu = b1 * st["mu"].get(p, torch.zeros_like(g)) + (1 - b1) * g
                nu = b2 * st["nu"].get(p, torch.zeros_like(g)) + (1 - b2) * g * g
                st["mu"][p], st["nu"][p] = mu, nu
                u = (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t)) + 1e-8)
                group_lr = lr * 20 if p[0] in MAIN_GRID else lr
                if p[0] == "density" and self.cfg["weight_decay"]:
                    u = u + self.cfg["weight_decay"] * p_leaves[p]
                new[p] = p_leaves[p] - group_lr * lr_scale * u
        return rebuild(params, new), adam


def slow_fast(fast, slow, labels, conf, num_labels: int, valid):
    """The slow-fast loss of one bundle: the first half of the rays are
    fast, the second slow. Concentration: over labels in both halves, minus
    the mean over a label's fast points of exp(-|fast - slow centroid|^2)
    times the confidence. Contrastive: -log of the share of exp(exp(-dist))
    over a fast point's same-label slow points, over fast points with one.
    0 when a half has no label."""
    n = labels.shape[0]
    idx = torch.arange(n, device=fast.device)
    fm = ((idx < n // 2) & valid).to(fast.dtype)
    sm = ((idx >= n // 2) & valid).to(fast.dtype)

    def per_label(v):
        out = torch.zeros((num_labels,) + v.shape[1:], dtype=v.dtype,
                          device=v.device)
        return out.index_add(0, labels, v)

    cf, cs = per_label(fm), per_label(sm)
    both = (cf > 0) & (cs > 0)
    centroid = per_label(slow * sm[:, None]) / cs.clamp(min=1.0)[:, None]
    point = torch.exp(-torch.sum((fast - centroid[labels]) ** 2, -1)) * conf * fm
    label_mean = per_label(point) / cf.clamp(min=1.0)
    n_both = both.sum()
    conc = torch.where(n_both > 0, torch.where(both, -label_mean, 0.0).sum()
                       / n_both.clamp(min=1), 0.0)
    pair = (fm[:, None] > 0) & (sm[None, :] > 0)
    match = (labels[:, None] == labels[None, :]) & pair
    dist = torch.sqrt(torch.clamp(torch.sum(
        (fast[:, None] - slow[None]) ** 2, -1), min=1e-24))
    logits = torch.exp(torch.exp(-dist)) * pair
    prob = (logits * match).sum(-1) / logits.sum(-1).clamp(min=1e-12)
    keep = prob > 0
    contrast = -torch.where(keep, torch.log(prob.clamp(min=1e-12)), 0.0).sum() \
        / keep.sum().clamp(min=1)
    ok = (cf.sum() > 0) & (cs.sum() > 0)
    return torch.where(ok, conc + contrast, 0.0)


def norms(tree_or_dict) -> dict:
    items = (tree_or_dict.items() if isinstance(tree_or_dict, dict)
             and all(isinstance(k, tuple) for k in tree_or_dict)
             else leaves(tree_or_dict))
    return {p: float(torch.linalg.norm(t.double())) for p, t in items}

