"""The multi-process runtime (the MPI-world analog) on ``torch.distributed``.

Counterpart of ``eigenkernel_tpu/parallel/multihost.py``:

* ``init_distributed`` — ``init_process_group`` on
  ``tcp://<coordinator>`` (the CLI passes ``EK_COORDINATOR``,
  ``EK_NUM_PROCESSES`` and ``EK_PROCESS_ID``): NCCL for CUDA, gloo for
  the CPU, unless the caller names the backend.
* ``bcast_coo`` — process 0 reads the MatrixMarket file and broadcasts the
  O(nnz) COO triplets; each process then densifies only its own block
  (``parallel.mesh.distribute_coo``).
* ``is_master`` — ``check_master`` analog (processes.f90:110-119).
* ``run_ranks`` — start a world of spawned processes on this host, each
  joining one group on 127.0.0.1 at a free port and running a function
  (the tests' grids, ``entry.dryrun_multichip``).

A single-process run (no process group) makes every helper a no-op.  The
broadcasts run on the current CUDA device under NCCL, which takes no CPU
tensor, and on the CPU otherwise.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import socket
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from eigenkernel_tpu_torch.core.types import MatrixInfo, SparseMatrix

TIMEOUT_S = 600  # a collective or the rendezvous waits this long at most


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the process group (mpi_init analog).

    No-op for a single-process run (no coordinator, at most one process)
    or when a group is already up.  With more than one process the
    coordinator (``host:port``) and this process's id must both be given:
    nothing waits on a peer that was not named.
    """
    if coordinator_address is None and num_processes in (None, 0, 1):
        return
    if dist.is_initialized():
        return
    if coordinator_address is None or process_id is None:
        raise ValueError(
            f"{num_processes} processes need a coordinator address "
            f"(EK_COORDINATOR=host:port) and a process id (EK_PROCESS_ID)")
    num_processes = num_processes or 1
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} out of range for "
                         f"{num_processes} processes")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_master() -> bool:
    """check_master analog: true on process 0."""
    return process_index() == 0


def _device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _bcast(x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(x).to(_device())
    dist.broadcast(t, 0)
    return t.cpu().numpy()


_REPS = ("coordinate", "array")
_FIELDS = ("real", "integer", "pattern")
_SYMMS = ("general", "symmetric", "skew-symmetric")


def bcast_ok(ok: bool) -> bool:
    """Coherent error propagation from process 0 (main.f90:65-68 analog):
    every process learns whether the master's read succeeded, so all stop
    together instead of deadlocking in a later broadcast."""
    if process_count() == 1:
        return ok
    return bool(_bcast(np.array([1 if ok else 0], np.int64))[0])


def bcast_matrix_info(info: Optional[MatrixInfo]) -> Optional[MatrixInfo]:
    """bcast_matrix_info analog (command_argument.f90:106-118): process 0
    probed the MatrixMarket header.  Returns None on every process when
    the master failed (``info`` None there)."""
    if process_count() == 1:
        return info
    if info is not None:
        vec = np.array([1, info.rows, info.cols, info.entries,
                        _REPS.index(info.rep), _FIELDS.index(info.field),
                        _SYMMS.index(info.symm)], np.int64)
    else:
        vec = np.zeros(7, np.int64)
    vec = _bcast(vec)
    if vec[0] == 0:
        return None
    return MatrixInfo(rep=_REPS[int(vec[4])], field=_FIELDS[int(vec[5])],
                      symm=_SYMMS[int(vec[6])], rows=int(vec[1]),
                      cols=int(vec[2]), entries=int(vec[3]))


def bcast_coo(sp: Optional[SparseMatrix], size: int,
              entries: int) -> SparseMatrix:
    """Broadcast a COO matrix from process 0 (bcast_sparse_matrix analog,
    distribute_matrix.f90:481-523): the three triplet arrays packed as one
    (3, entries) float64 array, as the JAX package packs them.  ``sp`` may
    be None off process 0; ``size`` and ``entries`` come from the
    broadcast header."""
    if process_count() == 1:
        if sp is None:
            raise ValueError("bcast_coo: a single process needs the matrix")
        return sp
    if sp is not None:
        pack = np.stack([sp.rows.astype(np.float64),
                         sp.cols.astype(np.float64),
                         sp.values.astype(np.float64)])
    else:
        pack = np.zeros((3, entries), np.float64)
    pack = _bcast(pack)
    return SparseMatrix(size=size, rows=pack[0].astype(np.int64),
                        cols=pack[1].astype(np.int64), values=pack[2])


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn: Callable, rank: int, world: int, port: int, args: tuple,
               backend: str) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    init_distributed(f"127.0.0.1:{port}", world, rank, backend)
    try:
        fn(rank, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, backend: str = "gloo",
              timeout: float = TIMEOUT_S) -> None:
    """Run ``fn(rank, *args)`` (a module-level function) on ``world``
    spawned processes that join one ``backend`` group (NCCL: card
    ``rank`` each), one thread each; raise unless every rank exits 0
    within ``timeout`` seconds.  Every process still alive then is
    killed."""
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, args, backend))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} of {fn.__name__} still "
                               f"running after {timeout} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"{fn.__name__}: rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
