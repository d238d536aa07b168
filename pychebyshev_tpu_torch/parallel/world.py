"""A process-group world on one host, for running and checking the
meshed paths without a launcher.

``run_world(fn, 4)`` spawns four processes (``start_world`` returns at
once, so the caller can work while they run); each joins a gloo process
group over a file store (``GLOO_SOCKET_IFNAME=lo`` unless the
environment names an interface), runs ``fn(rank, *args)`` and leaves
the group.  The parent waits with a deadline: a rank that raises is
re-raised in the parent with its traceback, and a world that outlives
the deadline is killed and reported, so a stuck collective never hangs
the caller.  Results travel through files that ``fn`` writes.
``local_world()`` makes the calling process a world of one rank.

``backend="nccl"`` spawns one rank per card instead (rank r on card
r).  A launcher works too (``torchrun --nproc-per-node=N``, NCCL), with
``torch.cuda.set_device(local_rank)`` before
``parallel.sharding.make_mesh``.  ``FileFunction`` names a rank
function of a script file that has no importable module name.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import os
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Callable

import torch
import torch.distributed as dist

__all__ = ["World", "FileFunction", "start_world", "run_world",
           "local_world", "check_replicated"]

# A collective that waits longer than this raises on its rank.
_COLLECTIVE_TIMEOUT = timedelta(seconds=60)


def _rank_main(rank: int, fn: Callable, world_size: int, store: str,
               args: tuple, backend: str = "gloo") -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kwargs["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank,
        world_size=world_size, timeout=_COLLECTIVE_TIMEOUT, **kwargs)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


class World:
    """Spawned ranks of one process group (see :func:`start_world`)."""

    def __init__(self, ctx, workdir: str, deadline_s: float):
        self._ctx = ctx
        self._workdir = workdir
        self._deadline_s = deadline_s
        self._deadline = time.monotonic() + deadline_s

    def wait(self) -> None:
        """Wait for every rank, at most until the deadline (counted from
        the start).  Raises ``torch.multiprocessing.ProcessRaisedException``
        (or ``ProcessExitedException``) when a rank fails, ``TimeoutError``
        when the deadline passes; either way no rank is left running."""
        try:
            while not self._ctx.join(timeout=1.0):
                if time.monotonic() > self._deadline:
                    raise TimeoutError(
                        f"a world of {len(self._ctx.processes)} ranks ran "
                        f"past its {self._deadline_s:g} s deadline; every "
                        f"rank was killed")
        finally:
            for proc in self._ctx.processes:
                if proc.is_alive():
                    proc.kill()
            for proc in self._ctx.processes:
                proc.join(10)
            shutil.rmtree(self._workdir, ignore_errors=True)


class FileFunction:
    """The module-level function ``name`` of the Python file ``path``, as
    a rank function: it pickles by path, and the rank loads the file
    under a private module name and calls it.  For scripts and files
    loaded by path, whose functions have no module name a spawned rank
    could import."""

    def __init__(self, path, name: str):
        self.path = os.path.abspath(path)
        self.name = name

    def __call__(self, *args):
        tag = hashlib.sha1(self.path.encode()).hexdigest()[:12]
        spec = importlib.util.spec_from_file_location(
            f"_pcb_world_file_{tag}", self.path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return getattr(module, self.name)(*args)


def start_world(fn: Callable, world_size: int, args: tuple = (), *,
                deadline_s: float = 120.0, backend: str = "gloo") -> World:
    """Start ``fn(rank, *args)`` on ``world_size`` spawned ranks of one
    process group and return at once; :meth:`World.wait` collects them.

    ``fn`` must be importable by name (a module-level function, or a
    :class:`FileFunction`) and so must ``args``.  Each rank runs on one
    thread (``torch.set_num_threads(1)``), and a collective that waits
    60 s raises on its rank.  ``backend="nccl"`` puts rank r on card r.
    """
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                         f"{backend!r}")
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(f"an NCCL world of {world_size} ranks needs as "
                         f"many cards; {torch.cuda.device_count()} visible")
    workdir = tempfile.mkdtemp(prefix="pcb-world-")
    ctx = torch.multiprocessing.start_processes(
        _rank_main,
        args=(fn, world_size, os.path.join(workdir, "store"), tuple(args),
              backend),
        nprocs=world_size, join=False, start_method="spawn")
    return World(ctx, workdir, deadline_s)


def run_world(fn: Callable, world_size: int, args: tuple = (), *,
              deadline_s: float = 120.0, backend: str = "gloo") -> None:
    """:func:`start_world`, then wait for every rank (see
    :meth:`World.wait`)."""
    start_world(fn, world_size, args, deadline_s=deadline_s,
                backend=backend).wait()


@contextlib.contextmanager
def local_world(backend: str = "gloo", device_id=None):
    """This process as a world of one rank, over a file store in a
    temporary directory (``backend="nccl"`` with ``device_id`` for one
    card); the group is destroyed on exit."""
    workdir = tempfile.mkdtemp(prefix="pcb-world-")
    kwargs = {} if device_id is None else {"device_id": device_id}
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=0, world_size=1, timeout=_COLLECTIVE_TIMEOUT, **kwargs)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)


def check_replicated(results: dict) -> None:
    """On every rank of the default group: raise unless this rank holds
    bitwise the same tensor as rank 0 under every key of ``results``
    (the same keys, in the same order, on every rank)."""
    for key, value in results.items():
        ref = value.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(ref, src=0)
        if not torch.equal(ref, value):
            raise AssertionError(
                f"rank {dist.get_rank()} holds another {key!r} than rank 0")
