"""The data-parallel layout, over ``torch.distributed``.

Port of ``contrastive_lift_tpu/parallel/mesh.py``. The JAX package lays one
``data`` mesh axis over its chips and lets GSPMD run the single-device
program on the global batch, inserting the collectives itself. Here each
rank is a process with its own card (NCCL) or CPU (gloo), and the port
reproduces that global program explicitly:

  * parameters and both Adam chains are replicated: ``replicate_tree``
    broadcasts rank 0's tensors at construction and after a restore (JAX's
    ``replicated`` sharding has no counterpart: a rank holds whole tensors);
  * every rank draws the global batch from the same seeded generator and
    keeps its own rows (``shard_main_batch``; ``shard_instance_batch`` keeps
    whole images, since the instance losses need each image's full ray-pair
    matrices), so a W-rank run consumes the random numbers of the 1-rank run;
  * each rank's loss is its share of the global loss (local sums over global
    counts), one all-reduce per optimizer chain sums the gradients, and the
    terms of the parameters alone are added once after it
    (``train/step.py``). This is not what ``DistributedDataParallel``
    computes by default (the mean of each rank's local means);
  * a render gives whole chunks to each rank (``group_batch_sharding``): the
    production render picks its termination survivors among a chunk's rays,
    so splitting the rays of a chunk would change the render.

``make_mesh`` joins the process group of a ``torchrun`` launch (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or of the
workers ``parallel/launch.py`` spawns (a file store named by
``INIT_FILE_ENV``). NCCL when each rank has its own card, gloo on the CPU;
gloo on a card only when asked for by name (ranks sharing one card). Gloo
reduces and broadcasts card tensors but gathers only host ones, so maps and
objects travel through a gloo group of host tensors (``Mesh.host_group``).
A group that cannot form raises; nothing falls back to one process.
"""
from __future__ import annotations

import datetime
import os
import pickle
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves_with_path

INIT_FILE_ENV = "CLT_DIST_INIT_FILE"
# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)

_MESH: Optional["Mesh"] = None


@dataclass
class Mesh:
    """One rank's view of the 1-axis data mesh."""
    rank: int
    size: int
    device: torch.device
    backend: str
    group: object       # collectives on ``device`` tensors
    host_group: object  # gloo: host tensors and objects
    axis: str = "data"
    # bytes of the all-reduces this rank took part in, for reports
    all_reduce_bytes: int = 0


def launched() -> bool:
    """Whether this process is a rank of a launch (torchrun's environment,
    or ``parallel/launch.py``'s)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def visible_devices(device) -> int:
    """The devices a data-parallel run on ``device`` may span: the ranks of
    the launch this process belongs to, else the visible cards (1 on the
    CPU)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if launched():
        return int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def _rank_device(device, local_rank: int, backend: str) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError(f"backend nccl needs a card, device is {dev}")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but "
                           "torch.cuda.is_available() is False")
    n_cards = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= n_cards:
        raise ValueError(
            f"local rank {local_rank} has no card of its own ({n_cards} "
            "visible): NCCL needs one card a rank; backend='gloo' lets "
            "ranks share a card")
    return torch.device("cuda", local_rank % n_cards)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              backend: Optional[str] = None, device=None,
              init_method: Optional[str] = None) -> Mesh:
    """This rank's mesh over the ``data`` axis, joining the process group
    once per process.

    The group comes from the launch's environment (``launched``), or, for a
    process outside a launch, from ``init_method`` as rank 0 of
    ``n_devices`` (default 1). ``device``: ``"cuda"`` puts each rank on card
    ``LOCAL_RANK``, ``"cpu"`` on the CPU (default: the card). ``backend``:
    default NCCL on cards and gloo on the CPU. ``n_devices`` (None or 0:
    every rank) must be the world's size. ``axis`` names the one mesh axis,
    as the JAX package's ``make_mesh`` does (``Config.data_axis``)."""
    global _MESH
    if _MESH is not None:
        if n_devices and n_devices != _MESH.size:
            raise ValueError(f"n_devices={n_devices} but the process group "
                             f"has {_MESH.size} ranks")
        return _MESH
    if dist.is_initialized():
        raise RuntimeError("a process group exists that make_mesh did not "
                           "create")
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if launched():
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        if INIT_FILE_ENV in os.environ:
            init_method = f"file://{os.environ[INIT_FILE_ENV]}"
        elif "MASTER_ADDR" in os.environ:
            init_method = "env://"
        else:
            raise RuntimeError("RANK and WORLD_SIZE are set but neither "
                               f"MASTER_ADDR nor {INIT_FILE_ENV}")
    elif init_method is not None:
        rank, world, local_rank = 0, n_devices or 1, 0
    else:
        raise RuntimeError(
            "no process group to join: launch the ranks with torchrun, or "
            "through contrastive_lift_tpu_torch.parallel.launch.spawn (the "
            "CLIs spawn their own)")
    if n_devices and n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the launch has {world} "
                         "ranks")
    dev = _rank_device(dev, local_rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    host = (dist.group.WORLD if backend == "gloo"
            else dist.new_group(backend="gloo", timeout=TIMEOUT))
    _MESH = Mesh(rank, world, dev, backend, dist.group.WORLD, host, axis)
    return _MESH


def close_mesh() -> None:
    """Leave the process group (each rank, at the end of its run)."""
    global _MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce_(mesh: Mesh, tensor: torch.Tensor, op: str = "sum"):
    """``tensor`` reduced over the ranks, in place (``op`` "sum" or "max")."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(tensor, op=red, group=mesh.group)
    mesh.all_reduce_bytes += tensor.numel() * tensor.element_size()
    return tensor


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's ``obj`` (picklable), on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.host_group)
    return box[0]


def agree(mesh: Mesh, value, what: str):
    """Rank 0's ``value``, after checking that every rank computed the same
    one: replicas that decided differently would fork, so every rank raises
    when they differ."""
    values = [None] * mesh.size
    dist.all_gather_object(values, value, group=mesh.host_group)
    if any(pickle.dumps(v) != pickle.dumps(values[0]) for v in values[1:]):
        raise RuntimeError(f"the ranks disagree on {what}: {values}")
    return values[0]


def _flat_groups(tensors):
    """[(dtype, [tensors of that dtype])], in first-seen order."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.items())


def replicate_tree(mesh: Mesh, tree):
    """``tree`` with rank 0's values in every tensor leaf (broadcast in
    place, one flat buffer per dtype); returns ``tree``."""
    leaves = [t for _, t in tree_leaves_with_path(tree)
              if isinstance(t, torch.Tensor)]
    with torch.no_grad():
        for _, group in _flat_groups(leaves):
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0, group=mesh.group)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()
    return tree


def all_reduce_tensors(mesh: Mesh, tensors: list) -> list:
    """The sums over the ranks of ``tensors``: one all-reduce of one flat
    buffer per dtype."""
    out = [None] * len(tensors)
    index = {id(t): i for i, t in enumerate(tensors)}
    for _, group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        all_reduce_(mesh, flat)
        offset = 0
        for t in group:
            out[index[id(t)]] = flat[offset:offset + t.numel()].view(t.shape)
            offset += t.numel()
    return out


def digest(tree) -> str:
    """sha256 of the bytes of every tensor leaf of ``tree`` (replicas that
    have not drifted have equal digests)."""
    import hashlib
    h = hashlib.sha256()
    for path, t in tree_leaves_with_path(tree):
        if isinstance(t, torch.Tensor):
            h.update(str(path).encode())
            h.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the layout of the batches and of the render chunks
# ---------------------------------------------------------------------------

def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a leading axis of ``n`` rows (rays or images),
    which must divide over the mesh."""
    if n % mesh.size:
        raise ValueError(f"a batch axis of {n} does not divide over "
                         f"{mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_main_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of each array of a ray batch."""
    return {k: v[batch_sharding(mesh, v.shape[0])] for k, v in batch.items()}


def shard_instance_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's whole images of instance bundles ([I, R, ...])."""
    return shard_main_batch(mesh, batch)


def group_batch_sharding(mesh: Mesh, n_chunks: int) -> range:
    """The chunks of a render that this rank renders: r, r + W, r + 2W, ...
    of the ``n_chunks`` in frame order. The port's chunk-to-rank assignment
    (the JAX package shards the ray axis of each chunk instead; see the
    module docstring)."""
    return range(mesh.rank, n_chunks, mesh.size)


def gather_chunks(mesh: Mesh, mine: dict, dst: Optional[int] = None) -> dict:
    """{chunk index: {key: numpy array}} of every rank's chunks, from
    ``mine`` (this rank's, tensors or arrays), through the host: on every
    rank, or with ``dst`` on that rank alone (the others get {})."""
    local = {j: {k: np.asarray(v.detach().cpu()) if isinstance(v, torch.Tensor)
                 else np.asarray(v) for k, v in maps.items()}
             for j, maps in mine.items()}
    parts = [None] * mesh.size
    if dst is None:
        dist.all_gather_object(parts, local, group=mesh.host_group)
    else:
        dist.gather_object(local, parts if mesh.rank == dst else None,
                           dst=dst, group=mesh.host_group)
        if mesh.rank != dst:
            return {}
    out = {}
    for part in parts:
        out.update(part)
    return out


def pad_batch_to_multiple(batch: dict, multiple: int, axis: int = 0) -> dict:
    """Pad ``axis`` of every array with zeros to a multiple of ``multiple``
    (the padded rows must be masked by the caller). The JAX package's
    helper, with its output; no path of either package calls it, since
    every batch axis must divide over the mesh."""
    out = {}
    for k, v in batch.items():
        n = v.shape[axis]
        pad = (-n) % multiple
        if pad:
            widths = [(0, 0)] * v.ndim
            widths[axis] = (0, pad)
            v = np.pad(v, widths)
        out[k] = v
    return out
