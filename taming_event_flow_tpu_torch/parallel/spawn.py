"""Run one function on several ranks, each in a child process started with
the ``spawn`` method (CUDA forbids ``fork``), and collect what each rank
returns. For the multi-process tests and ``chip_smoke.py``; a training or
eval run is launched with ``torchrun`` instead.

``fn(rank, world, *args)`` must be importable by name from the child (a
module-level function) and return something picklable. The child
initializes no process group itself: ``fn`` does, with a rendezvous the
caller passes in ``args`` (a ``file://`` path of its own, say), and the
child destroys the group when ``fn`` returns.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback

import torch.distributed as dist


def _child(fn, rank, world, args, out):
    try:
        item = (rank, True, fn(rank, world, *args))
    except BaseException:  # reported to the parent, which raises
        item = (rank, False, traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out.put(item)


def run_ranks(fn, world: int, args=(), timeout: float = 600.0):
    """Run ``fn(rank, world, *args)`` for ``rank`` in ``range(world)``, one
    child process each, and return their results in rank order.

    :raises RuntimeError: with the child's traceback when a rank raises, or
        when a child dies without a result or the run outlasts ``timeout``
        seconds; the remaining children are terminated first.
    """
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, rank, world, args, out))
             for rank in range(world)]
    for p in procs:
        p.start()
    results, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world and failure is None:
            try:
                rank, ok, payload = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    failure = f"rank {dead[0]} died with exit code " \
                              f"{procs[dead[0]].exitcode} and no result"
                elif time.monotonic() > deadline:
                    failure = f"ranks timed out after {timeout:.0f} s"
                continue
            if ok:
                results[rank] = payload
            else:
                failure = f"rank {rank} raised:\n{payload}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=30.0)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [results[r] for r in range(world)]
