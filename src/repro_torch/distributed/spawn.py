"""Run a function on ``world`` ranks of one process group, one process each.

    results = run_ranks(fn, world=4, args=(...,), backend="gloo", timeout=120)

Each rank is a fresh process (the ``spawn`` start method) that joins a
``torch.distributed`` group at ``tcp://localhost:<free port>`` with its
rank and the world size, calls ``fn(rank, world, *args)`` and returns its
result to the caller; ``results[r]`` is rank r's. ``fn`` must be importable
by name (a module-level function). Build what the ranks share (the CUDA
kernels) before calling: the ranks only load it.

A rank that raises sends its traceback; the other ranks are then
terminated and :class:`RankError` carries it. Ranks still running at
``timeout`` seconds are terminated and the call raises
:class:`TimeoutError`. Every process started is joined before return.
"""

from __future__ import annotations

import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["RankError", "free_port", "run_ranks"]


class RankError(RuntimeError):
    """A rank raised; the message holds its traceback."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _rank_main(fn, rank, world, port, backend, threads, device, args, q):
    if threads:
        torch.set_num_threads(threads)
    kw = {}
    if device is not None:
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = torch.device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, **kw)
    try:
        out = fn(rank, world, *args)
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()
    q.put((rank, True, out))


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (), *, backend: str = "gloo",
              timeout: float = 120.0, threads: Optional[int] = 1,
              device: Optional[object] = None) -> List[Any]:
    """``[fn(r, world, *args) for each rank r]``, run concurrently on
    ``world`` processes of one ``backend`` group. ``threads`` sets each
    rank's intra-op threads (None keeps torch's default); ``device`` is
    the CUDA device each rank makes current (None: the CPU)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, backend, threads, device, tuple(args), q))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} "
                                   f"did not finish in {timeout:.0f} s")
            try:
                rank, ok, out = q.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RankError(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RankError(f"rank {rank} raised:\n{out}")
            results[rank] = out
    finally:
        if len(results) < world:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
