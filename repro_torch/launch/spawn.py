"""Run one function in N new processes that form one process group.

``run_processes(fn, n, args)`` starts ``n`` processes through
``torch.multiprocessing`` (the spawn start method), makes them ranks
0..n-1 of a CPU process group (gloo) (``launch.mesh.init_distributed``, rendezvous
through a file under a fresh directory, so concurrent runs never share a
port), calls ``fn(*args)`` in each and returns the values in rank order.
Each process's output goes to its own log file; when a process raises,
dies or outlives ``timeout``, every process is stopped and the error
carries every process's log, with every thread's stack of each process
still running as it stood.  ``fn`` must be importable by name (a
module-level function).  With ``init=False`` the processes get the
environment ``torchrun`` gives (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) and ``fn`` starts the group itself.
"""

from __future__ import annotations

import faulthandler
import os
import pickle
import shutil
import signal
import tempfile
import time
import traceback
from pathlib import Path


class ProcessesFailed(RuntimeError):
    """A process of ``run_processes`` raised, died or ran out of time."""


def _entry(rank, fn, args, world, workdir, threads, pg_timeout, port):
    workdir = Path(workdir)
    log = open(workdir / f"rank{rank}.log", "w", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    import sys
    sys.stdout = sys.stderr = log
    # the parent asks for every thread's stack before it kills a process
    # that outlived the run's timeout
    faulthandler.register(signal.SIGUSR1, file=log, all_threads=True)
    # one host: keep gloo on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if port is not None:
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    torch.set_num_threads(threads)
    try:
        if port is None:
            init_distributed("cpu", rank=rank, world_size=world,
                             init_method=f"file://{workdir / 'rendezvous'}",
                             timeout=pg_timeout)
        result = ("ok", fn(*args))
    except BaseException:               # noqa: BLE001 — reported to the parent
        result = ("error", traceback.format_exc())
        traceback.print_exc()
    with open(workdir / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    log.flush()
    if result[0] != "ok":
        # exit at once, without the group's teardown (its peers may wait in
        # a collective): the parent sees the exit and stops them all
        os._exit(1)
    if dist.is_initialized():
        dist.destroy_process_group()
    log.flush()


def _logs(workdir: Path, n: int) -> str:
    out = []
    for r in range(n):
        p = workdir / f"rank{r}.log"
        text = p.read_text() if p.exists() else "(no log)"
        out.append(f"---- rank {r} ----\n{text[-6000:]}")
    return "\n".join(out)


def run_processes(fn, nprocs: int, args: tuple = (), *,
                  timeout: float = 600.0, pg_timeout: float = 120.0,
                  threads: int | None = None, init: bool = True) -> list:
    """``fn(*args)`` on ranks 0..nprocs-1 of a new CPU (gloo) process group.

    Returns the values in rank order, or raises ``ProcessesFailed`` with
    every process's log.  ``pg_timeout`` bounds a collective's wait for a
    peer; ``timeout`` bounds the whole run; ``threads`` is each process's
    torch thread count (default: the host's cores shared out)."""
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    port = None if init else free_port()
    threads = threads or max(1, (os.cpu_count() or 1) // nprocs)
    workdir = Path(tempfile.mkdtemp(prefix="ranks_"))
    try:
        ctx = mp.start_processes(
            _entry, args=(fn, args, nprocs, str(workdir), threads,
                          pg_timeout, port),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, min(
                    5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise ProcessesFailed(
                        f"{nprocs} processes of {fn.__name__} ran past "
                        f"{timeout} s")
        except BaseException as e:
            for p in ctx.processes:
                if p.is_alive():
                    os.kill(p.pid, signal.SIGUSR1)
            time.sleep(2)
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
            if isinstance(e, ProcessesFailed):
                raise ProcessesFailed(f"{e}\n{_logs(workdir, nprocs)}") from None
            raise ProcessesFailed(f"a process of {fn.__name__} died: {e}\n"
                                  f"{_logs(workdir, nprocs)}") from e
        results = []
        for r in range(nprocs):
            with open(workdir / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        if any(status != "ok" for status, _ in results):
            raise ProcessesFailed(f"a process of {fn.__name__} raised\n"
                                  f"{_logs(workdir, nprocs)}")
        return [value for _, value in results]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
