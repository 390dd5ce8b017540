"""Start N ranks on this host in fresh processes (spawned, not forked) and
collect what each returns: the in-process counterpart of ``python -m
torch.distributed.run --nproc-per-node N`` for tests, tools and the smoke
script.

Each rank gets the variables ``torch.distributed.run`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``
``127.0.0.1`` and a free ``MASTER_PORT``) and runs ``fn(*args)``; ``fn``
joins the group itself (:func:`~multi_modal_gnn_tpu_torch.parallel.mesh.init_axis`).
``fn`` must be importable by name (a module-level function), and what it
returns must pickle without torch tensors (numpy arrays instead: a tensor
crosses to the parent as a file descriptor that closes when its rank
exits).  A rank that raises makes :func:`run_ranks` raise with
that rank's traceback; every process is ended before it returns.
:class:`Ranks` starts them and lets the caller work before it collects.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence


def free_port() -> int:
    """A TCP port on the loopback interface that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, inbox, env: Dict[str, str], results) -> None:
    os.environ.update(env)
    try:
        out = fn(*inbox.get())
        results.put((int(env["RANK"]), True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((int(env["RANK"]), False, traceback.format_exc()))
    finally:
        from multi_modal_gnn_tpu_torch.parallel.mesh import shutdown

        shutdown()


class Ranks:
    """``world_size`` ranks running ``fn(*args)``, started at construction;
    :meth:`join` collects what each returns (the caller may work
    meanwhile)."""

    def __init__(self, fn: Callable, world_size: int, args: Sequence[Any] = ()):
        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self._results = ctx.Queue()
        # the arguments go through a queue, not the spawn pipe: a payload
        # larger than the pipe would hold ``start()`` until the rank has
        # imported ``fn``'s module, one rank after the other
        self._inbox = inbox = ctx.Queue()  # held until the ranks have read it
        port = str(free_port())
        self._procs = []
        for rank in range(world_size):
            rank_env = {
                "RANK": str(rank), "WORLD_SIZE": str(world_size), "LOCAL_RANK": str(rank),
                "LOCAL_WORLD_SIZE": str(world_size), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
            }
            p = ctx.Process(target=_rank_main, args=(fn, inbox, rank_env, self._results), daemon=True)
            p.start()
            self._procs.append(p)
        for _ in range(world_size):
            inbox.put(tuple(args))

    def join(self, timeout: float = 600.0) -> List[Any]:
        """``[what rank 0 returned, ..., rank world_size - 1]``; raises with
        the traceback of a rank that failed.  Every process is ended."""
        out: Dict[int, Any] = {}
        errors = []
        try:
            deadline = time.monotonic() + timeout
            while len(out) + len(errors) < self.world_size:
                try:
                    rank, ok, value = self._results.get(timeout=1.0)
                except queue.Empty:
                    missing = sorted(set(range(self.world_size)) - set(out))
                    dead = [r for r in missing if self._procs[r].exitcode is not None]
                    # a rank writes its result before it exits: an exited rank
                    # with nothing left to read died (a signal, a failed start)
                    if dead and self._results.empty():
                        raise RuntimeError(f"ranks {dead} of {self.world_size} exited with no result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks {missing} gave no result in {timeout} s")
                    continue
                if ok:
                    out[rank] = value
                else:
                    errors.append((rank, value))
                    break  # the others may wait on the failed rank forever
        finally:
            for p in self._procs:
                p.join(timeout=5 if not errors else 0.1)
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(f"rank {rank} of {self.world_size} failed:\n{tb}")
        return [out[r] for r in range(self.world_size)]


def run_ranks(fn: Callable, world_size: int, args: Sequence[Any] = (), timeout: float = 600.0) -> List[Any]:
    """``[fn(*args) of rank 0, ..., of rank world_size - 1]``."""
    return Ranks(fn, world_size, args).join(timeout)
