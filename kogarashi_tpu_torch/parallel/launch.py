"""Start `world` ranks of torch.distributed and return rank 0's result.

The JAX package has no counterpart: its mesh lives in one process, where
`shard_map` runs the per-device bodies. Here every rank is a process,
started with `torch.multiprocessing.spawn`:

  * backend "nccl": rank r runs on cuda:r; fewer visible cards than ranks
    raise before anything starts. Backend "gloo": every rank runs on the
    CPU, on one torch thread. No other backend is taken, and none is
    picked for the caller.
  * The ranks meet through a `file://` store in a temporary directory, so
    no port or network is used.
  * Every rank is joined under one deadline. A rank that raises, dies or
    is still running at the deadline fails the call, and the other ranks
    are ended.
  * Rank 0's return value comes back to the caller through a pickle file
    in the same directory. The process group is destroyed on every way out
    of a rank.

`fn` is pickled by reference, so it must be a module-level function of
this package (or of the standard library): a spawned rank imports the
module that holds it and nothing of the caller's.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = {"nccl": "cuda", "gloo": "cpu"}  # backend -> the device type of its ranks
PG_TIMEOUT_S = 60  # the longest a collective waits for the other ranks


def rank_device() -> torch.device:
    """This rank's device: cuda:r under NCCL (set by `launch`), the CPU under gloo."""
    backend = dist.get_backend()
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"backend {backend!r}: expected one of {sorted(BACKENDS)}")


def _rank_main(rank, fn, args, world, backend, init_method, out_path):
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timedelta(seconds=PG_TIMEOUT_S))
    try:
        out = fn(*args)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_each(calls):
    """[(fn, args), ...] -> [fn(*args), ...] in order, on this rank: several
    rank functions in one launch, which costs a process start per rank."""
    return [fn(*args) for fn, args in calls]


def launch(fn, world: int, backend: str, args=(), timeout_s: float = 600.0):
    """Run fn(*args) on `world` ranks of a fresh process group; return rank
    0's result. Raises ValueError on an unknown backend, RuntimeError when
    NCCL is asked for more ranks than there are visible cards, TimeoutError
    when a rank is still running after `timeout_s`, and torch's
    ProcessRaisedException / ProcessExitedException (with the rank's
    traceback) when a rank raises or dies."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {sorted(BACKENDS)}")
    if world < 1:
        raise ValueError(f"world {world}: need at least one rank")
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            raise RuntimeError(f"nccl with {world} ranks needs {world} CUDA devices, {have} visible")
    with tempfile.TemporaryDirectory(prefix="kt_ranks_") as tmpdir:
        out_path = os.path.join(tmpdir, "rank0.pkl")
        init_method = "file://" + os.path.join(tmpdir, "rendezvous")
        ctx = mp.spawn(_rank_main, nprocs=world, join=False,
                       args=(fn, args, world, backend, init_method, out_path))
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} {backend} ranks still running after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
        with open(out_path, "rb") as f:
            return pickle.load(f)
