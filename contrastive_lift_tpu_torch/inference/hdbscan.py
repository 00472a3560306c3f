"""HDBSCAN as ``inference/cluster.py`` calls it: the port's counterpart of
``sklearn.cluster.HDBSCAN(min_cluster_size=m, min_samples=1,
allow_single_cluster=True).fit(X).labels_`` (euclidean, excess-of-mass
selection), which the card's machine does not have.

With ``min_samples=1`` scikit-learn's core distance is the distance to the
nearest neighbour counting the point itself, so it is 0: the mutual
reachability distance is the plain distance and the tree is the
single-linkage tree. The steps follow ``sklearn/cluster/_hdbscan``:

1. the minimum spanning tree by Prim's algorithm
   (``_linkage.pyx::mst_from_data_matrix``): in torch on ``device``, one
   row of float64 distances per step and no n x n matrix, the next node the
   first of the nearest (scikit-learn's tie order);
2. the edges sorted by distance with numpy's default sort, as
   ``hdbscan.py::_process_mst`` sorts them, and merged into the
   single-linkage tree with a union-find (``make_single_linkage``);
3. the condensed tree, the cluster stabilities and the excess-of-mass
   selection with ``allow_single_cluster`` (``_tree.pyx``), then the
   labels: each point takes its nearest selected ancestor, noise is -1, and
   when the root is the one cluster a point joins it only if it left the
   root no earlier than its latest-leaving sibling (``_do_labelling``).
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..utils.device import resolve_device


def minimum_spanning_tree(points, device="cuda"):
    """Prim's MST of ``points`` [n, d] under the euclidean distance, as
    scikit-learn's ``mst_from_data_matrix`` builds it with zero core
    distances: (source [n-1] int64, target [n-1] int64, distance [n-1]
    float64), edge i added at step i.

    ``reach`` holds each node's distance to the tree, +inf once it is in
    the tree; ``blocked`` adds +inf to the distances of nodes in the tree,
    so that a step needs no mask (adding its 0 leaves the others exact).
    The current node is a one-element index tensor: indexing with a 0-d
    device tensor would read it back to the host at every step."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(points, np.float64), device=dev)
    n, d = x.shape
    inf = float("inf")
    reach = torch.full((n,), inf, dtype=torch.float64, device=dev)
    blocked = torch.zeros(n, dtype=torch.float64, device=dev)
    sources = torch.zeros(n, dtype=torch.int64, device=dev)
    edges_src = torch.empty(max(n - 1, 0), dtype=torch.int64, device=dev)
    edges_dst = torch.empty_like(edges_src)
    edges_dist = torch.empty(max(n - 1, 0), dtype=torch.float64, device=dev)
    current = torch.zeros(1, dtype=torch.int64, device=dev)
    blocked.index_fill_(0, current, inf)
    for i in range(n - 1):
        # scikit-learn's EuclideanDistance: the squared differences summed
        # feature by feature, then the square root
        sq = x - x.index_select(0, current)
        sq = sq * sq
        dist = sq[:, 0]
        for f in range(1, d):
            dist = dist + sq[:, f]
        dist = torch.sqrt(dist) + blocked
        closer = dist < reach
        reach = torch.where(closer, dist, reach)
        sources = torch.where(closer, current, sources)
        nxt = torch.argmin(reach).reshape(1)    # the first of the minima
        edges_src[i:i + 1] = sources.index_select(0, nxt)
        edges_dst[i:i + 1] = nxt
        edges_dist[i:i + 1] = reach.index_select(0, nxt)
        reach.index_fill_(0, nxt, inf)
        blocked.index_fill_(0, nxt, inf)
        current = nxt
    return (edges_src.cpu().numpy(), edges_dst.cpu().numpy(),
            edges_dist.cpu().numpy())


def single_linkage(src, dst, dist):
    """``_process_mst`` + ``make_single_linkage``: the merges
    (left, right, distance, size) [n-1] in order of distance, clusters
    numbered n, n+1, ... as they form."""
    order = np.argsort(dist)
    n = len(src) + 1
    parent = np.arange(2 * n - 1)
    size = np.concatenate([np.ones(n, np.int64), np.zeros(n - 1, np.int64)])
    left = np.empty(n - 1, np.int64)
    right = np.empty(n - 1, np.int64)
    sizes = np.empty(n - 1, np.int64)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for k, e in enumerate(order):
        a, b = find(src[e]), find(dst[e])
        left[k], right[k] = a, b
        sizes[k] = size[a] + size[b]
        parent[a] = parent[b] = n + k
        size[n + k] = sizes[k]
    return left, right, dist[order], sizes


def _bfs(left, right, n, root):
    """``_tree.pyx::bfs_from_hierarchy``: the nodes under ``root``,
    breadth first."""
    out, queue = [], [root]
    while queue:
        out.extend(queue)
        queue = [c for x in queue if x >= n
                 for c in (left[x - n], right[x - n])]
    return out


def condense_tree(left, right, dist, sizes, min_cluster_size: int):
    """``_tree.pyx::_condense_tree``: rows (parent, child, lambda,
    child size) of the condensed tree, clusters numbered from n."""
    n = len(left) + 1
    root = 2 * (n - 1)
    left, right = left.tolist(), right.tolist()
    relabel = {root: n}
    next_label = n + 1
    rows = []
    ignore = np.zeros(root + 1, bool)
    for node in _bfs(left, right, n, root):
        if ignore[node] or node < n:
            continue
        k = node - n
        lo, hi = left[k], right[k]
        lam = 1.0 / dist[k] if dist[k] > 0.0 else np.inf
        lo_count = sizes[lo - n] if lo >= n else 1
        hi_count = sizes[hi - n] if hi >= n else 1
        parent = relabel[node]
        if lo_count >= min_cluster_size and hi_count >= min_cluster_size:
            for child, count in ((lo, lo_count), (hi, hi_count)):
                relabel[child] = next_label
                rows.append((parent, next_label, lam, count))
                next_label += 1
            continue
        if lo_count < min_cluster_size and hi_count >= min_cluster_size:
            relabel[hi] = parent
            fall = (lo,)
        elif hi_count < min_cluster_size and lo_count >= min_cluster_size:
            relabel[lo] = parent
            fall = (hi,)
        else:
            fall = (lo, hi)
        for side in fall:
            for sub in _bfs(left, right, n, side):
                if sub < n:
                    rows.append((parent, sub, lam, 1))
                ignore[sub] = True
    rows = np.array(rows, dtype=[("parent", np.int64), ("child", np.int64),
                                 ("value", np.float64),
                                 ("cluster_size", np.int64)])
    return rows


def stabilities(tree) -> dict:
    """``_tree.pyx::_compute_stability``: sum over each cluster's rows of
    (lambda - the cluster's birth lambda) * size, in row order."""
    parents = tree["parent"]
    smallest = int(parents.min())
    births = np.full(max(int(tree["child"].max()), smallest) + 1, np.nan)
    births[tree["child"]] = tree["value"]
    births[smallest] = 0.0
    result = np.zeros(int(parents.max()) - smallest + 1)
    for parent, lam, size in zip(parents.tolist(), tree["value"].tolist(),
                                 tree["cluster_size"].tolist()):
        result[parent - smallest] += (lam - births[parent]) * size
    return {smallest + i: result[i] for i in range(len(result))}


def select_clusters(tree, stability: dict):
    """Excess-of-mass selection with ``allow_single_cluster``
    (``_tree.pyx::_get_clusters``): the set of selected cluster ids; the
    root is a candidate."""
    nodes = sorted(stability, reverse=True)
    cluster_tree = tree[tree["cluster_size"] > 1]
    children = {}
    for p, c in zip(cluster_tree["parent"].tolist(),
                    cluster_tree["child"].tolist()):
        children.setdefault(p, []).append(c)
    is_cluster = {c: True for c in nodes}
    for node in nodes:
        kids = children.get(node, [])
        subtree = np.sum([stability[c] for c in kids])
        if subtree > stability[node]:
            is_cluster[node] = False
            stability[node] = subtree
        else:
            queue = deque(kids)
            while queue:
                sub = queue.popleft()
                is_cluster[sub] = False
                queue.extend(children.get(sub, []))
    return {c for c, keep in is_cluster.items() if keep}


def label_points(tree, clusters: set) -> np.ndarray:
    """``_tree.pyx::_do_labelling`` with ``allow_single_cluster`` (no
    epsilon): labels 0.. in order of cluster id, -1 for noise."""
    root = int(tree["parent"].min())
    label_of = {c: i for i, c in enumerate(sorted(clusters))}
    up = dict(zip(tree["child"].tolist(), tree["parent"].tolist()))
    point_lambda = dict(zip(tree["child"].tolist(), tree["value"].tolist()))
    single = len(clusters) == 1
    threshold = (tree["value"][tree["parent"] == root].max()
                 if single else None)
    labels = np.full(root, -1, np.int64)
    resolved = {}
    for point in range(root):
        # the nearest selected ancestor, or the root
        node, path = up[point], []
        while node != root and node not in clusters and node not in resolved:
            path.append(node)
            node = up[node]
        top = resolved.get(node, node)
        for p in path:
            resolved[p] = top
        if top != root:
            labels[point] = label_of[top]
        elif single and root in clusters and point_lambda[point] >= threshold:
            labels[point] = label_of[root]
    return labels


def hdbscan_labels(points, min_cluster_size: int, device="cuda") -> np.ndarray:
    """Labels of ``points`` [n, d] as scikit-learn's ``HDBSCAN(
    min_cluster_size=min_cluster_size, min_samples=1,
    allow_single_cluster=True).fit(points).labels_``: 0..k-1 for the
    clusters, -1 for noise. The spanning tree is built on ``device``; the
    rest runs on the host."""
    points = np.asarray(points)
    if points.shape[0] < 2:
        raise ValueError("HDBSCAN needs more than one sample")
    src, dst, dist = minimum_spanning_tree(points, device)
    tree = condense_tree(*single_linkage(src, dst, dist), min_cluster_size)
    clusters = select_clusters(tree, stabilities(tree))
    return label_points(tree, clusters)
