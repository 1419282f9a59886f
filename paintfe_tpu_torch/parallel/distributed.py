"""Multi-process distribution: torch.distributed init + process-aware meshes
(paintfe_tpu.parallel.distributed counterpart).

The reference has no distributed layer to port (SURVEY §2.9): this is the
framework's own scale-out design.  One process per host; each process owns
its local cards.  Batch work shards two ways:

- **compute**: each process runs its images on its own cards
  (parallel.mesh.batch_mesh).  `global_batch_mesh` and the 2-D
  `slice_mesh` ('dcn' across processes, 'ici' over each process's cards)
  describe every card of the job, each entry with its process index.
- **I/O**: globbing, decode and encode are per process; `shard_inputs`
  deals each process a deterministic slice of the input list, so
  processes never touch the same file.

Wire-up is env-driven, so the CLI works unchanged on one host and under a
launcher: PAINTFE_COORDINATOR (host:port of process 0's rendezvous),
PAINTFE_NUM_PROCESSES, PAINTFE_PROCESS_ID.

**Why gloo and not NCCL.**  The layer's collectives run on CPU tensors.
Two are control plane: the exit-code flag (`all_processes_ok`) and the
device lists (`global_batch_mesh`, `slice_mesh`).  The other is spatial
sharding across processes (parallel/spatial.py): a check that every
process makes the same call, and the gather of the row blocks' results
to the process that owns the mesh's first entry, each block through a
pinned host buffer (gloo's send and recv move CPU tensors only).  Batch
sharding needs no collective on the card.  NCCL also refuses two ranks
on one card ("Duplicate GPU detected"), and two processes sharing one
card is a layout this layer must run (a host with one card).  A gather
card to card on an NCCL group, one rank a card, would skip the host
copies where each process has cards of its own.
"""

from __future__ import annotations

import atexit
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from paintfe_tpu_torch.parallel.mesh import Mesh, batch_mesh


def maybe_initialize(verbose: bool = False) -> bool:
    """Join the process group when a multi-process launch is requested.

    Returns True when running as part of a multi-process job (after
    initialization), False for plain single-process runs.  Safe to call
    more than once: a process that already joined returns True.
    """
    coord = os.environ.get("PAINTFE_COORDINATOR")
    nproc = os.environ.get("PAINTFE_NUM_PROCESSES")
    pid = os.environ.get("PAINTFE_PROCESS_ID")
    if (coord or nproc or pid) and not (coord and nproc and pid):
        # Partial wiring is a launcher bug: silently degrading to N
        # independent single-process runs makes every host process the
        # full input list and race on the same output files.
        missing = [n for n, v in (("PAINTFE_COORDINATOR", coord),
                                  ("PAINTFE_NUM_PROCESSES", nproc),
                                  ("PAINTFE_PROCESS_ID", pid)) if not v]
        raise RuntimeError(
            "partial multi-process wiring: missing " + ", ".join(missing))
    if not coord:
        # no explicit wiring: multi-process only when this process already
        # joined a group of more than one
        return dist.is_initialized() and dist.get_world_size() > 1
    if not dist.is_initialized():
        address = coord if "://" in coord else f"tcp://{coord}"
        dist.init_process_group("gloo", init_method=address,
                                world_size=int(nproc), rank=int(pid))
        atexit.register(_leave)
    if verbose:
        print(f"[distributed] process {dist.get_rank()}/{dist.get_world_size()}"
              f" with {torch.cuda.device_count()} local card(s)")
    return True


def _leave():
    """Leave the process group at exit: a gloo group still open when the
    interpreter tears down can abort the process (SIGABRT, "terminate
    called without an active exception") after it agreed on its exit
    code."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    """This process's index in the job (0 outside one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The job's number of processes (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _gathered_devices(local: Optional[Sequence]) -> list:
    """Every process's local devices, in rank order: [[devices of 0], ...].
    `local` defaults to this process's cards (batch_mesh)."""
    mine = [str(d) for d in (local if local is not None else batch_mesh().devices.flat)]
    if world_size() == 1:
        return [mine]
    every = [None] * world_size()
    dist.all_gather_object(every, mine)
    if len({len(d) for d in every}) != 1:
        raise RuntimeError(f"processes hold different numbers of devices: "
                           f"{[len(d) for d in every]}")
    return every


def global_batch_mesh(local: Optional[Sequence] = None) -> Mesh:
    """Flat 1-D mesh over every process's local devices, axis 'batch'."""
    every = _gathered_devices(local)
    return Mesh([d for devs in every for d in devs], ("batch",),
                [p for p, devs in enumerate(every) for _ in devs])


def slice_mesh(local: Optional[Sequence] = None) -> Mesh:
    """2-D ('dcn', 'ici') mesh: processes (hosts) on the outer axis, each
    process's local devices on the inner axis.

    Work that communicates per step (halo exchange) belongs on 'ici'; 'dcn'
    carries only batch-level scatter and gather, mirroring the cost of
    links inside a host against links between hosts."""
    every = _gathered_devices(local)
    return Mesh(np.array(every, dtype=object), ("dcn", "ici"),
                np.repeat(np.arange(len(every)), len(every[0])))


def shard_inputs(inputs: Sequence, process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> List:
    """Deterministic per-process slice of a work list (round-robin).

    Round-robin (rather than contiguous blocks) keeps the load even when
    input sizes correlate with their position in the glob order.
    """
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    return list(inputs)[pi::pc]


def all_processes_ok(local_ok: bool) -> bool:
    """Cross-process AND of per-process success flags (for exit codes).

    Every process learns whether any peer failed, so all exit with the
    same code; on a single process this is just `local_ok`.
    """
    if world_size() == 1:
        return bool(local_ok)
    flag = torch.tensor([0.0 if local_ok else 1.0], dtype=torch.float32)
    dist.all_reduce(flag)  # sum over processes, on the CPU (gloo)
    return float(flag.item()) == 0.0
