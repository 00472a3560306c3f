"""Post-hoc clustering of rendered instance embeddings -> discrete object ids.

Port of the global-clustering path of ``contrastive_lift_tpu/inference/
cluster.py``:

  * ``create_instances_from_semantics``: prepend a ±inf flag channel marking
    stuff pixels (channel 0 == -inf <=> thing pixel);
  * ``cluster``: 3-sigma outlier rejection -> min/max rescale to the unit
    cube -> 50k subsample (numpy ``default_rng(seed)``, so both packages
    cluster the same points) -> mean-shift with bin seeding -> predict
    labels for ALL pixels -> +1 shift (orphans/stuff -> 0) -> one-hot.

HDBSCAN (``use_dbscan``) and the segment-wise / cached-centroid variants are
not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..ops.meanshift import MeanShift, silverman_bandwidth

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


def _fit_predict(features: np.ndarray, all_features: np.ndarray, bandwidth,
                 use_silverman: bool, rng: np.random.Generator, device):
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
    if sample.shape[0] < 100:
        return None
    bw = (silverman_bandwidth(sample.shape[0], sample.shape[1])
          if use_silverman else bandwidth)
    ms = MeanShift(bandwidth=bw, bin_seeding=True, min_bin_freq=10,
                   cluster_all=False, device=device).fit(sample)
    all_labels = ms.predict((all_features - bias) * scale)
    return all_labels, ms.cluster_centers_ / scale + bias


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

    ``cluster_size`` only sizes HDBSCAN clusters; ``use_dbscan`` is not
    ported and raises."""
    if use_dbscan:
        raise NotImplementedError("cluster: use_dbscan (HDBSCAN) is not ported")
    rng = np.random.default_rng(seed)
    thing_mask = all_thing_features[..., 0] == -np.inf
    features = all_thing_features[thing_mask][:, 1:]
    all_features = all_thing_features[:, 1:]
    result = _fit_predict(features, all_features, bandwidth, use_silverman,
                          rng, device)
    if result is None:
        all_labels = np.full(all_features.shape[0], -1, np.int64)
    else:
        all_labels = result[0].astype(np.int64)
    all_labels[~thing_mask] = -1
    return _one_hot_instances(all_labels, num_images)
