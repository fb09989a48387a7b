"""Start the ranks of a multi-device run, one process a rank.

``read_tpu`` runs its mesh from one controller; the port runs one
process per rank (``torch.multiprocessing``, the ``spawn`` start
method) joined by ``torch.distributed``. :func:`spawn` starts ``world``
processes, each of which calls ``init_process_group`` on a ``file://``
store in a fresh directory under the run's temporary directory (no port
to pick), with an explicit timeout that its collectives share, runs
``fn(rank, world, device, *args)`` and leaves the group. The parent
joins every child against a deadline and raises if a rank fails, exits
or outlives it; nothing is retried.

The backend is a stated rule (:func:`choose_backend`), which rank 0
prints on its first line: NCCL when every rank has a CUDA card of its
own, else gloo (on the CPU, and for ranks that share a card). Rank ``r``
takes ``cuda:(r % torch.cuda.device_count())``. A CPU rank runs
:data:`CPU_THREADS` intra-op thread, so several ranks beside other work
do not oversubscribe the cores.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["CPU_THREADS", "choose_backend", "spawn"]

CPU_THREADS = 1


def choose_backend(world: int, device_type: str):
    """``(backend, reason)`` for ``world`` ranks on ``device_type``
    ('cuda' or 'cpu'): 'nccl' when every rank has a card of its own, else
    'gloo'."""
    if device_type == "cpu":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if world <= cards:
        return "nccl", f"every rank has a card of its own ({cards} cards)"
    return "gloo", (f"{world} ranks share {cards} card(s); NCCL takes one "
                    "rank a card")


def _rank_main(rank: int, fn, world: int, device_type: str, store: str,
               timeout_s: float, args: tuple) -> None:
    device = torch.device("cpu") if device_type == "cpu" else \
        torch.device("cuda", rank % torch.cuda.device_count())
    backend, why = choose_backend(world, device_type)
    if rank == 0:
        print(f"[launch] {world} rank(s) on {device_type}: backend "
              f"{backend} ({why})", flush=True)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(CPU_THREADS)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, world, device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, device_type: str, args: tuple = (),
          timeout_s: float = 600.0, join_s: float = None) -> None:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes
    (``fn`` and ``args`` must pickle: a function at a module's top
    level). ``timeout_s`` bounds every collective and the group's
    set-up; ``join_s`` (default: no bound) the whole run, after which the
    ranks are killed and ``TimeoutError`` raised. A rank that raises
    makes this raise (``torch.multiprocessing.ProcessRaisedException``,
    with its traceback) after the others are stopped."""
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type {device_type!r}: 'cpu' or 'cuda'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn: no CUDA device for the ranks")
    tmp = tempfile.mkdtemp(prefix="read_tpu_torch_dist_")
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(fn, world, device_type, os.path.join(tmp, "store"),
                  float(timeout_s), tuple(args)))
        deadline = None if join_s is None else time.monotonic() + join_s
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                for proc in ctx.processes:
                    proc.join(5.0)
                raise TimeoutError(f"spawn: {world} ranks still running "
                                   f"after {join_s} s; killed")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
