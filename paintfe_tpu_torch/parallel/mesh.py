"""Device meshes (paintfe_tpu.parallel.mesh counterpart).

The reference is a single-process desktop app (SURVEY §2.9): its parallelism
is rayon rows + wgpu workgroups.  The scaling axis here is the batch of
images: a 1-D mesh ('batch',) over this process's cards, images split on
the leading axis, each entry running the whole op chain on its slice.
Within-image tiling (halo exchange for an image that spans cards, on the
cards of one process or of several) is parallel/spatial.py.

A `Mesh` is an array of torch.device entries with axis names.  An entry
may repeat a device: work on repeated entries of one card runs in turn on
that card's current stream, work on distinct cards overlaps, because each
launch goes to its tensor's card (ops/kernels.device_guard,
launch_stream).  On the CPU, torch has one device, so a CPU mesh of n
entries is n entries of torch.device("cpu").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Devices arranged on named axes.  `devices` is an object array of
    torch.device of one dimension per axis name; `process_indices` gives
    the process that owns each entry (this process's rank by default)."""

    def __init__(self, devices, axis_names, process_indices=None):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(f"mesh: {arr.shape} devices do not fit axes {axis_names}")
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.axis_names = tuple(axis_names)
        if process_indices is None:
            from paintfe_tpu_torch.parallel.distributed import rank

            process_indices = np.full(arr.shape, rank())
        self.process_indices = np.asarray(process_indices, dtype=np.int64).reshape(arr.shape)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as jax.sharding.Mesh.shape reads."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How a tensor lies on a mesh: spec[d] names the mesh axis that tensor
    dimension d is split over in contiguous blocks, or None (the dimension
    is whole on every entry); dimensions past the spec are whole.  An
    empty spec replicates the tensor on every entry."""

    mesh: Mesh
    spec: tuple = ()

    def place(self, x: torch.Tensor) -> np.ndarray:
        """The block of `x` that each mesh entry holds, on that entry's
        device, as an object array shaped like mesh.devices.  Each split
        dimension must divide by its axis size (pad first).  A block on
        the tensor's own device is a view, not a copy."""
        sizes = self.mesh.shape
        for d, axis in enumerate(self.spec):
            if axis is not None and x.shape[d] % sizes[axis]:
                raise ValueError(f"sharding: dimension {d} ({x.shape[d]}) does not "
                                 f"divide over axis {axis!r} ({sizes[axis]})")
        out = np.empty(self.mesh.devices.shape, dtype=object)
        copies = {}  # one copy of a replicated tensor per distinct device
        for idx in np.ndindex(out.shape):
            block = x
            for d, axis in enumerate(self.spec):
                if axis is not None:
                    n = x.shape[d] // sizes[axis]
                    k = idx[self.mesh.axis_names.index(axis)]
                    block = block.narrow(d, k * n, n)
            dev = self.mesh.devices[idx]
            if any(a is not None for a in self.spec):
                out[idx] = to_device(block, dev)
            else:
                if dev not in copies:
                    copies[dev] = to_device(block, dev)
                out[idx] = copies[dev]
        return out


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`: itself where it already lies there; a copy queued
    on the streams of both cards between cards, and from the host; a copy
    the host waits for from a card to the host."""
    return t.to(device, non_blocking=device.type == "cuda")


def _local_cards() -> list:
    from paintfe_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def batch_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over this process's cards (cuda:0 ... cuda:{count - 1}),
    axis name 'batch'; raises when there is no card.

    Local (not global) devices on purpose: the CLI batch path shards the
    *file list* across processes (parallel.distributed.shard_inputs), so
    each process computes its own images on its own cards.  For a mesh
    over every process's cards use parallel.distributed.global_batch_mesh()."""
    return Mesh(list(devices) if devices is not None else _local_cards(), ("batch",))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """[N, H, W, C] tensors split on the leading (batch) axis."""
    return NamedSharding(mesh, ("batch",))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def pad_batch(n: int, mesh: Mesh) -> int:
    """Round a batch size up to a multiple of the mesh size."""
    d = mesh.devices.size
    return ((n + d - 1) // d) * d


def as_mesh(mesh_or_device) -> Mesh:
    """A Mesh as it is; None or "cuda" (a card with no index) as
    batch_mesh(), this process's cards; any other device as the one-entry
    'batch' mesh over it."""
    if isinstance(mesh_or_device, Mesh):
        return mesh_or_device
    from paintfe_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda" if mesh_or_device is None else mesh_or_device)
    if dev.type == "cuda" and dev.index is None:
        return batch_mesh()
    return Mesh([dev], ("batch",))
