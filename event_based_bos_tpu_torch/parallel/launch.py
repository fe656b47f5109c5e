"""Start the ranks of a mesh: under ``torchrun``, or as spawned processes.

The JAX package runs a mesh as one program over the devices of one
process; the port runs one process a mesh position.  :func:`run` calls a
function on every rank of an N-rank world:

  * inside an initialised process group of N ranks (a rank of this module,
    or a program that set up its own group) it just calls the function;
  * under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` in the
    environment) it joins the group from the environment, calls the
    function and leaves the group;
  * otherwise it spawns N processes (``torch.multiprocessing``'s ``spawn``
    start method) that meet through a ``FileStore`` in a new temporary
    directory (no port to collide on), and returns rank 0's result.

A rank on the GPU takes card ``local rank mod card count``; on the CPU it
runs one torch thread.  The backend is NCCL when every rank has a card of
its own, gloo when ranks share a card or run on the CPU; the choice is
logged once.  When a spawned rank raises, the others are terminated (none
is left waiting in a collective) and the parent re-raises the first
rank's exception; a rank that dies without one raises ``RuntimeError``,
and the whole run raises ``TimeoutError`` past ``deadline`` seconds.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["run", "rank_device", "choose_backend", "under_torchrun"]

#: this process's rank device, set when it joins a group through :func:`run`
_DEVICE: Optional[torch.device] = None


def rank_device() -> torch.device:
    """This rank's device: the one :func:`run` gave it, else the GPU."""
    return _DEVICE if _DEVICE is not None else resolve_device(None)


def choose_backend(device_type: str, ranks_per_host: int,
                   n_cuda: int) -> str:
    """NCCL when every rank of a host has a GPU of its own, else gloo
    (NCCL refuses two ranks on one GPU)."""
    if device_type == "cuda" and ranks_per_host <= n_cuda:
        return "nccl"
    return "gloo"


def under_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR"))


def _set_rank_device(device_type: str, local_rank: int) -> torch.device:
    global _DEVICE
    if device_type == "cuda":
        index = local_rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        _DEVICE = torch.device("cuda", index)
    else:
        torch.set_num_threads(1)
        _DEVICE = torch.device(device_type)
    return _DEVICE


def _rank_main(rank, world, init_method, device_type, backend, timeout, fn,
               args, results):
    """A spawned rank: join the group, call ``fn``, report to the parent."""
    try:
        _set_rank_device(device_type, rank)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", pickle.dumps(out if rank == 0 else None)))
    except BaseException as e:  # reported to the parent, which re-raises
        try:
            payload = pickle.dumps(e)
        except Exception:
            payload = None
        results.put((rank, "error", payload, traceback.format_exc()))


def _terminate(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


def _spawn(fn, world, args, device_type, backend, timeout, deadline):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="ebt_mesh_")
    init_method = "file://" + os.path.join(store_dir, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, init_method, device_type, backend,
                               timeout, fn, args, results))
             for r in range(world)]
    end = None if deadline is None else time.monotonic() + deadline
    try:
        for p in procs:
            p.start()
        done, out = set(), None
        while len(done) < world:
            try:
                msg = results.get(timeout=0.2)
            except queue_mod.Empty:
                msg = None
            if msg is not None and msg[1] == "error":
                _terminate(procs)
                rank, _kind, payload, tb = msg
                logger.error("rank %d failed:\n%s", rank, tb)
                exc = pickle.loads(payload) if payload is not None else None
                if isinstance(exc, BaseException):
                    raise exc
                raise RuntimeError(f"rank {rank} failed:\n{tb}")
            if msg is not None:
                done.add(msg[0])
                if msg[0] == 0:
                    out = pickle.loads(msg[2])
                continue
            dead = [r for r, p in enumerate(procs)
                    if r not in done and p.exitcode not in (None, 0)]
            if dead:
                _terminate(procs)
                raise RuntimeError(f"rank {dead[0]} died with exit code "
                                   f"{procs[dead[0]].exitcode}")
            if end is not None and time.monotonic() > end:
                _terminate(procs)
                raise TimeoutError(f"the {world} ranks did not finish "
                                   f"within {deadline} s")
        for p in procs:
            p.join()
        return out
    finally:
        _terminate(procs)
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)


def run(fn: Callable, world: int, args=(), device=None,
        timeout: float = 120.0, deadline: Optional[float] = None):
    """Call ``fn(*args)`` on each rank of a ``world``-rank group on
    ``device``'s type (the GPU unless the caller asks for the CPU).

    ``timeout`` bounds the group's join and every collective; ``deadline``
    (spawned ranks only) the whole run.  Returns ``fn``'s result on this
    rank (spawned: rank 0's, which must pickle).
    """
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"{world} ranks were asked for inside a process "
                             f"group of {dist.get_world_size()}")
        return fn(*args)
    device_type = resolve_device(device).type
    if world == 1:
        # one rank needs no group: this process is it
        global _DEVICE
        before = _DEVICE
        _DEVICE = resolve_device(device)
        try:
            return fn(*args)
        finally:
            _DEVICE = before
    n_cuda = torch.cuda.device_count() if device_type == "cuda" else 0
    if under_torchrun():
        env_world = int(os.environ["WORLD_SIZE"])
        if env_world != world:
            raise ValueError(f"{world} ranks were asked for; torchrun started "
                             f"{env_world}")
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = choose_backend(device_type, per_host, n_cuda)
        _set_rank_device(device_type, local)
        if int(os.environ["RANK"]) == 0:
            logger.info("mesh backend: %s (%d ranks, %d on this host, %d "
                        "GPUs)", backend, world, per_host, n_cuda)
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    backend = choose_backend(device_type, world, n_cuda)
    logger.info("mesh backend: %s (%d spawned ranks, %d GPUs)", backend,
                world, n_cuda)
    return _spawn(fn, world, args, device_type, backend, timeout, deadline)
