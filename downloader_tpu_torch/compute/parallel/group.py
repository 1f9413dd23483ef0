"""Run one function in a process group of ``n`` fresh processes.

The training path is multi-controller: one process per device, joined by
``torch.distributed`` (NCCL on cards, gloo on the CPU).  ``run_group``
starts those processes itself, for callers that are not already inside
a group (``train()`` over every visible card, ``dryrun_multichip``, the
tests' CPU groups):

- the parent holds the group's ``TCPStore``, bound to port 0, so two
  groups on one machine never race for a port;
- rank ``r`` drives ``cuda:r`` (NCCL), or the CPU with one intra-op
  thread (gloo), and every collective times out after
  :data:`COLLECTIVE_TIMEOUT`;
- the workers are spawned (never forked: the parent may hold threads and
  a CUDA context); the parent reads every message before it joins them,
  kills any that outlive ``timeout`` or whose peer failed, and raises
  with the traceback of every rank that failed.
"""

from __future__ import annotations

import datetime
import queue as queue_mod
import time
import traceback
from typing import Callable, List, Optional, Sequence

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


class _Log:
    """A worker's log: lines go to the parent, which emits them."""

    def __init__(self, messages, rank: int):
        self._messages, self.rank = messages, rank

    def __call__(self, line: str) -> None:
        self._messages.put(("log", self.rank, str(line)))


def _worker(fn, rank: int, world: int, port: int, device_type: str,
            args: tuple, messages) -> None:
    import torch
    import torch.distributed as dist

    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            backend = "nccl"
        else:
            torch.set_num_threads(1)
            backend = "gloo"
        store = dist.TCPStore("127.0.0.1", port, is_master=False,
                              timeout=COLLECTIVE_TIMEOUT)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=COLLECTIVE_TIMEOUT)
        try:
            result = fn(_Log(messages, rank), *args)
        finally:
            dist.destroy_process_group()
        messages.put(("done", rank, result))
    except BaseException:
        messages.put(("error", rank, traceback.format_exc()))
        raise


def run_group(fn: Callable, world: int, device_type: str = "cuda",
              args: Sequence = (), timeout: float = 600.0,
              log: Optional[Callable[[str], None]] = None) -> List:
    """Run ``fn(log, *args)`` on ranks 0..world-1 of a new process group
    and return each rank's result, in rank order.

    ``fn`` and ``args`` are pickled into the workers (``fn`` a top-level
    function); ``log`` in a worker sends a line to this process, which
    passes it to ``log`` here.  ``device_type`` ``"cuda"`` puts rank
    ``r`` on ``cuda:r`` and needs ``world`` cards; ``"cpu"`` runs gloo.
    Raises ``RuntimeError`` with the traceback of every rank that failed
    (or died silently), ``TimeoutError`` after ``timeout`` seconds."""
    import multiprocessing

    import torch
    import torch.distributed as dist

    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}")
    if device_type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"a group of {world} ranks needs {world} cards, "
                           f"have {torch.cuda.device_count()}")
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False, timeout=COLLECTIVE_TIMEOUT)
    ctx = multiprocessing.get_context("spawn")
    messages = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, rank, world, store.port, device_type,
                               tuple(args), messages))
             for rank in range(world)]
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            proc.start()
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                if errors:
                    break
                raise TimeoutError(f"process group of {world} ranks still "
                                   f"running after {timeout:.0f} s")
            try:
                kind, rank, payload = messages.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                silent = [r for r, p in enumerate(procs) if p.exitcode not in
                          (None, 0) and r not in results and r not in errors]
                if silent:
                    errors[silent[0]] = (f"exited with code "
                                         f"{procs[silent[0]].exitcode}")
                continue
            if kind == "log":
                if log is not None:
                    log(payload)
            elif kind == "error":
                errors[rank] = payload
                # a peer's collective fails once this rank is gone: give
                # the other ranks a moment to report, so the cause is in
                # the message beside its consequences
                deadline = min(deadline, time.monotonic() + 2.0)
            else:
                results[rank] = payload
        if errors:
            raise RuntimeError("\n".join(
                f"rank {rank} of {world} failed:\n{errors[rank]}"
                for rank in sorted(errors)))
        for proc in procs:
            proc.join(max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.pid is None:
                continue  # never started
            if proc.is_alive():
                proc.kill()
            proc.join(5)
        messages.close()
        del store
    return [results[rank] for rank in range(world)]
