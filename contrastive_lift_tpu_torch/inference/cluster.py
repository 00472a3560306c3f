"""Post-hoc clustering of rendered instance embeddings -> discrete object ids.

Port of ``contrastive_lift_tpu/inference/cluster.py``:

  * ``create_instances_from_semantics``: prepend a ±inf flag channel marking
    stuff pixels (channel 0 == -inf <=> thing pixel);
  * ``cluster``: 3-sigma outlier rejection -> min/max rescale to the unit
    cube -> 50k subsample (numpy ``default_rng(seed)``, so both packages
    cluster the same points) -> mean-shift with bin seeding, or HDBSCAN
    (``inference/hdbscan.py``, scikit-learn's algorithm) -> predict labels
    for ALL pixels -> +1 shift (orphans/stuff -> 0) -> one-hot;
  * ``cluster_segmentwise``: the same per predicted thing class with label
    offsets, also returning per-class centroids;
  * ``assign_clusters``: nearest-centroid assignment from cached centroids.

The distance work (mean-shift, HDBSCAN's spanning tree, the nearest-centre
assignment) runs on ``device``.
"""
from __future__ import annotations

import numpy as np

import torch

from ..ops.meanshift import MeanShift, _nearest_center, silverman_bandwidth
from ..utils.device import resolve_device
from .hdbscan import hdbscan_labels

NUM_CLUSTER_POINTS = 50_000


def create_instances_from_semantics(instances: np.ndarray, semantics: np.ndarray,
                                    thing_classes) -> np.ndarray:
    """[N, D] embeddings + [N, C] semantics -> [N, D+1] padded features.

    Channel 0 is -inf for thing pixels, +inf for stuff pixels."""
    sem_labels = np.asarray(semantics).argmax(axis=1)
    stuff_mask = ~np.isin(sem_labels, np.asarray(list(thing_classes)))
    padded = np.full((instances.shape[0], instances.shape[1] + 1), -np.inf,
                     np.float32)
    padded[:, 1:] = instances
    padded[stuff_mask, 0] = np.inf
    return padded


def _nearest(points: np.ndarray, centers: np.ndarray, device) -> np.ndarray:
    """Index of each point's nearest centre (float32, on ``device``)."""
    dev = resolve_device(device)
    return _nearest_center(
        torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(centers, np.float32)).to(dev),
        0.0).cpu().numpy()


def _fit_predict(features: np.ndarray, all_features: np.ndarray, bandwidth,
                 use_dbscan: bool, use_silverman: bool, cluster_size: int,
                 rng: np.random.Generator, device):
    """Filter/rescale/subsample/cluster/predict-all.

    Returns (labels for all_features rows, centroids in original scale) or
    None when the class is degenerate (too few points / no clusters)."""
    if features.shape[0] == 0:
        return None
    centmean, centstd = features.mean(axis=0), features.std(axis=0)
    inlier = np.all(np.abs(features - centmean) < 3 * centstd, axis=1)
    filtered = features[inlier]
    if filtered.shape[0] == 0:
        return None
    bias = filtered.min(axis=0)
    scale = 1.0 / np.maximum(filtered.max(axis=0) - filtered.min(axis=0), 1e-12)
    rescaled = (filtered - bias) * scale

    if rescaled.shape[0] <= NUM_CLUSTER_POINTS:
        sample = rescaled
    else:
        sample = rescaled[rng.choice(rescaled.shape[0], NUM_CLUSTER_POINTS,
                                     replace=False)]
    if not use_dbscan:
        if sample.shape[0] < 100:
            return None
        bw = (silverman_bandwidth(sample.shape[0], sample.shape[1])
              if use_silverman else bandwidth)
        ms = MeanShift(bandwidth=bw, bin_seeding=True, min_bin_freq=10,
                       cluster_all=False, device=device).fit(sample)
        centroids_scaled = ms.cluster_centers_
        all_labels = ms.predict((all_features - bias) * scale)
    else:
        labels = hdbscan_labels(sample, cluster_size, device=device)
        if not np.any(labels != -1):
            return None
        centroids_scaled = np.stack([sample[labels == cid].mean(axis=0)
                                     for cid in np.unique(labels) if cid != -1])
        all_labels = _nearest((all_features - bias) * scale,
                              centroids_scaled, device)
    return all_labels, centroids_scaled / scale + bias


def _one_hot_instances(all_labels: np.ndarray, num_images: int) -> np.ndarray:
    """+1 shift then one-hot: labels -1..K-1 -> channels 0..K."""
    shifted = all_labels + 1
    num = int(shifted.max()) + 1
    onehot = np.zeros((shifted.shape[0], num), np.float32)
    onehot[np.arange(shifted.shape[0]), shifted] = 1.0
    return onehot.reshape(num_images, -1, num)


def cluster(all_thing_features: np.ndarray, bandwidth: float, num_images: int,
            use_dbscan: bool = False, use_silverman: bool = False,
            cluster_size: int = 500, seed: int = 0,
            device="cuda") -> np.ndarray:
    """Global clustering -> [num_images, pixels, K+1] one-hot instances.

    ``cluster_size`` is HDBSCAN's min_cluster_size (``use_dbscan``)."""
    rng = np.random.default_rng(seed)
    thing_mask = all_thing_features[..., 0] == -np.inf
    features = all_thing_features[thing_mask][:, 1:]
    all_features = all_thing_features[:, 1:]
    result = _fit_predict(features, all_features, bandwidth, use_dbscan,
                          use_silverman, cluster_size, rng, device)
    if result is None:
        all_labels = np.full(all_features.shape[0], -1, np.int64)
    else:
        all_labels = result[0].astype(np.int64)
    all_labels[~thing_mask] = -1
    return _one_hot_instances(all_labels, num_images)


def cluster_segmentwise(all_thing_features: np.ndarray,
                        all_points_semantics: np.ndarray, bandwidth: float,
                        num_images: int, use_dbscan: bool = False,
                        use_silverman: bool = False, cluster_size: int = 500,
                        seed: int = 0, device="cuda"):
    """Per-thing-class clustering with label offsets; returns
    (one-hot instances, {thing_class: centroids}). One generator serves the
    classes in increasing order, as in the JAX package."""
    rng = np.random.default_rng(seed)
    sem_labels = np.asarray(all_points_semantics).argmax(axis=-1).reshape(-1)
    thing_mask = all_thing_features[..., 0] == -np.inf
    features = all_thing_features[thing_mask][:, 1:]
    thing_semantics = sem_labels[thing_mask]

    all_labels = np.zeros(all_thing_features.shape[0], np.int64)
    thing_labels = np.zeros(features.shape[0], np.int64)
    max_label = 0
    centroids_by_class = {}
    for thing_cls in np.unique(thing_semantics):
        cls_mask = thing_semantics == thing_cls
        cls_features = features[cls_mask]
        result = _fit_predict(cls_features, cls_features, bandwidth,
                              use_dbscan, use_silverman, cluster_size, rng,
                              device)
        if result is None:
            thing_labels[cls_mask] = -1
            continue
        cls_labels, centroids = result
        cls_labels = cls_labels.astype(np.int64)
        centroids_by_class[int(thing_cls)] = centroids
        cls_labels[cls_labels != -1] += max_label
        if np.any(cls_labels != -1):
            max_label = cls_labels.max() + 1
        thing_labels[cls_mask] = cls_labels

    all_labels[thing_mask] = thing_labels
    all_labels[~thing_mask] = -1
    return _one_hot_instances(all_labels, num_images), centroids_by_class


def assign_clusters(all_thing_features: np.ndarray,
                    all_points_semantics: np.ndarray,
                    centroids_by_class: dict, num_images: int,
                    device="cuda") -> np.ndarray:
    """Assign every thing pixel to its class's nearest cached centroid;
    classes without centroids are noise."""
    sem_labels = np.asarray(all_points_semantics).argmax(axis=-1).reshape(-1)
    thing_mask = all_thing_features[..., 0] == -np.inf
    features = all_thing_features[thing_mask][:, 1:]
    thing_semantics = sem_labels[thing_mask]

    all_labels = np.zeros(all_thing_features.shape[0], np.int64)
    thing_labels = np.zeros(features.shape[0], np.int64)
    max_label = 0
    for thing_cls in np.unique(thing_semantics):
        cls_mask = thing_semantics == thing_cls
        if int(thing_cls) not in centroids_by_class:
            thing_labels[cls_mask] = -1
            continue
        labels = _nearest(features[cls_mask],
                          np.asarray(centroids_by_class[int(thing_cls)],
                                     np.float32), device).astype(np.int64)
        labels += max_label
        max_label = labels.max() + 1
        thing_labels[cls_mask] = labels

    all_labels[thing_mask] = thing_labels
    all_labels[~thing_mask] = -1
    return _one_hot_instances(all_labels, num_images)
