"""Run p ranks as spawned processes on this host.

:func:`spawn` runs one function in every rank and returns each rank's
result; :class:`Pool` keeps p ranks alive and runs job after job in all of
them (the tests' gloo worlds).  Each rank gets the environment
``lifecycle.start`` reads (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` on a free localhost
port).  Processes start with the ``spawn`` method: CUDA cannot be forked.
A rank's exception fails the call with that rank's traceback; every wait
has a timeout, and every process is joined or killed before returning.
"""

from __future__ import annotations

import os
import queue as _queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, nproc: int, port: int) -> Dict[str, str]:
    return {"RANK": str(rank), "WORLD_SIZE": str(nproc),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(nproc),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


class RankError(RuntimeError):
    """A rank raised, died or ran out of time."""


def _collect(q, procs, n: int, deadline: float) -> Dict[int, Any]:
    """One (rank, ok, value) message from each of n ranks; raises
    RankError with the first rank's traceback if any failed."""
    results: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    while len(results) + len(errors) < n:
        try:
            rank, ok, value = q.get(timeout=0.5)
        except _queue.Empty:
            dead = [r for r, pr in enumerate(procs) if not pr.is_alive()
                    and r not in results and r not in errors]
            if dead:
                raise RankError(f"ranks {dead} exited without a result"
                                + "".join(f"\nrank {r} failed:\n{e}"
                                          for r, e in errors.items()))
            if time.monotonic() > deadline:
                raise RankError("ranks did not finish in time"
                                + "".join(f"\nrank {r} failed:\n{e}"
                                          for r, e in errors.items()))
            continue
        (results if ok else errors)[rank] = value
    if errors:
        r = min(errors)
        raise RankError(f"rank {r} failed:\n{errors[r]}")
    return results


def _stop(procs) -> None:
    for pr in procs:
        pr.join(timeout=20)
    for pr in procs:
        if pr.is_alive():
            pr.kill()
            pr.join()


def _spawn_main(rank, nproc, port, fn, args, q) -> None:
    os.environ.update(_rank_env(rank, nproc, port))
    try:
        q.put((rank, True, fn(*args)))
    except BaseException:  # noqa: BLE001 - sent to the parent, which raises
        q.put((rank, False, traceback.format_exc()))


def spawn(nproc: int, fn: Callable, args: Sequence = (),
          timeout_s: float = 1800.0) -> List[Any]:
    """``fn(*args)`` in each of ``nproc`` spawned ranks; returns the results
    in rank order.  ``fn`` must be importable (a module-level function)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_spawn_main,
                         args=(r, nproc, port, fn, tuple(args), q))
             for r in range(nproc)]
    for pr in procs:
        pr.start()
    try:
        res = _collect(q, procs, nproc, time.monotonic() + timeout_s)
        return [res[r] for r in range(nproc)]
    finally:
        _stop(procs)


def _pool_main(rank, nproc, port, setup, jobs, q) -> None:
    os.environ.update(_rank_env(rank, nproc, port))
    try:
        if setup is not None:
            setup()
        q.put((rank, True, None))
    except BaseException:  # noqa: BLE001
        q.put((rank, False, traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            return
        fn, args = job
        try:
            q.put((rank, True, fn(*args)))
        except BaseException:  # noqa: BLE001
            q.put((rank, False, traceback.format_exc()))


class Pool:
    """``nproc`` ranks that stay up and run :meth:`run` jobs in turn.
    ``setup`` (importable, no arguments) runs once in each rank first,
    e.g. ``lifecycle.start(device="cpu")``."""

    def __init__(self, nproc: int, setup: Callable = None,
                 timeout_s: float = 300.0):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.nproc = nproc
        self.timeout_s = timeout_s
        self._q = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(nproc)]
        port = free_port()
        self._procs = [ctx.Process(target=_pool_main,
                                   args=(r, nproc, port, setup, self._jobs[r],
                                         self._q), daemon=True)
                       for r in range(nproc)]
        for pr in self._procs:
            pr.start()
        try:
            _collect(self._q, self._procs, nproc,
                     time.monotonic() + timeout_s)
        except BaseException:
            self.close()
            raise

    def run(self, fn: Callable, *args) -> List[Any]:
        """``fn(*args)`` in every rank; the results in rank order."""
        for jq in self._jobs:
            jq.put((fn, args))
        res = _collect(self._q, self._procs, self.nproc,
                       time.monotonic() + self.timeout_s)
        return [res[r] for r in range(self.nproc)]

    def close(self) -> None:
        for pr, jq in zip(self._procs, self._jobs):
            if pr.is_alive():
                jq.put(None)
        _stop(self._procs)
