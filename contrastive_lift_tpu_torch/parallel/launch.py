"""Start the ranks of a data-parallel run on one host.

The JAX package needs no launcher on one host (one process drives every
chip); the port runs one process per rank. ``data_shards`` resolves a run's
``n_data_shards`` against the launch this process belongs to, or against the
visible cards; ``spawn`` starts that many workers with the ``spawn`` start
method (CUDA forbids ``fork``), joined through a file store, and returns rank
0's result. A worker that raises, or a run that outlasts ``timeout``, stops
every worker and raises here: a launch never falls back to one process.
Under ``torchrun`` (``parallel/mesh.py::launched``) nothing is spawned: each
process is already a rank.
"""
from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from . import mesh as pmesh


def data_shards(n: int, device) -> int:
    """The ranks of a run with ``n_data_shards=n`` on ``device``: those of
    the launch this process is a rank of (``n`` must be 0 or their number),
    else ``n``, 0 meaning every visible card (1 on the CPU). More ranks than
    visible cards raise ``ValueError``."""
    if pmesh.launched():
        world = int(os.environ["WORLD_SIZE"])
        if n not in (0, world):
            raise ValueError(f"n_data_shards={n} but the launch has {world} "
                             "ranks")
        return world
    avail = pmesh.visible_devices(device)
    if n == 0:
        return avail
    if torch.device(device).type == "cuda" and n > avail:
        raise ValueError(f"n_data_shards={n} but only {avail} devices")
    return n


def _worker(local_rank: int, fn: Callable, args: tuple, world: int,
            init_file: str, result_file: str, threads: int) -> None:
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(world))
    os.environ[pmesh.INIT_FILE_ENV] = init_file
    torch.set_num_threads(threads)
    try:
        result = fn(*args)
        if local_rank == 0:
            with open(result_file, "wb") as f:
                pickle.dump(result, f)
    finally:
        pmesh.close_mesh()
    # A finished worker leaves without the interpreter's finalisation: after
    # a training run, a runtime thread left joinable at exit can abort the
    # process ("terminate called without an active exception", now and then
    # on a loaded host), which would fail a run that succeeded.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn(fn: Callable, nprocs: int, args: tuple = (),
          timeout: Optional[float] = None, store_dir=None,
          threads: Optional[int] = None):
    """Run ``fn(*args)`` in ``nprocs`` worker processes, rank r in the r-th,
    and return rank 0's result. Each worker finds its rank in the
    environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``) and the group's
    file store in ``parallel/mesh.py::INIT_FILE_ENV``, so
    ``mesh.make_mesh`` joins the group; ``fn`` and ``args`` must pickle.
    ``store_dir``: where the store and the result file go (default a fresh
    temporary directory, removed afterwards). ``threads``: torch threads a
    worker (default this process's divided among the workers). A worker's
    exception is raised here; past ``timeout`` seconds every worker is
    killed and ``TimeoutError`` raised."""
    import torch.multiprocessing as mp
    own = store_dir is None
    root = Path(tempfile.mkdtemp(prefix="clt_dist_") if own
                else tempfile.mkdtemp(prefix="clt_dist_", dir=store_dir))
    threads = threads or max(1, torch.get_num_threads() // nprocs)
    init_file, result_file = root / "store", root / "result.pkl"
    try:
        ctx = mp.start_processes(
            _worker, args=(fn, args, nprocs, str(init_file), str(result_file),
                           threads),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=5.0):
            if deadline is not None and time.monotonic() > deadline:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                for proc in ctx.processes:
                    proc.join()
                raise TimeoutError(f"{nprocs} workers of {fn.__name__} "
                                   f"still ran after {timeout} s; killed")
        with open(result_file, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
