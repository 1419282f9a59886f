"""Spatial sharding: one huge canvas split across cards
(paintfe_tpu.parallel.spatial counterpart).

Batch sharding (parallel/pipeline.py) covers the many-images case; this
module covers the one-giant-image case (the reference clamps documents at
256 Mpix — src/canvas/tiled_image.rs:14-26 — which exceeds one card's
appetite for fused f32 intermediates).  The image's rows are split over a
mesh ('rows') whose entries may belong to several processes of a job
(parallel/distributed.py):

- **the row split**: H is padded by edge replication to a multiple of the
  'rows' size, and each mesh entry holds one block of hb rows on its
  device (a view where the image already lies there);
- **the halo exchange** (`_halo_extend`): before a neighbourhood kernel,
  each block receives the last r rows of the block above and the first r
  rows of the block below; the end blocks replicate their own edge row,
  which is the single-device kernel's edge clamp, so cropping r rows at
  each end of every block's result gives the single-device bytes;
- **the per-block kernel calls**: each entry runs the same kernel as the
  single-device call on its (extended) block: K-chain, K-median, K-blur
  through a caller's `fn`, K-composite (pointwise: no halo) and K-warp
  (the whole source on every entry's device, the field row-split).
  Entries on one card run in turn on its current stream; entries on
  distinct cards overlap, since each launch goes to its tensor's card.

**Across processes.**  As under JAX, where `jax.device_put` of one host
value onto a global sharding takes the same whole input in every
process, every process of the job calls with the same whole input and
builds only its own entries' blocks, from its own copy.  A neighbour
block on this process lends its halo rows device to device; the halo of
a neighbour on another process is the same r rows of the local input,
so no rows cross processes before the kernels.  Only the gather does:
every other process copies its cropped results to pinned host buffers
and sends them over gloo (`dist.isend`, one message a block, tagged with
its entry), and the process that owns the mesh's first entry (the
owner) posts one `dist.irecv` a remote block before it runs its own
kernels, then uploads and joins them.  Block shapes follow from the
call, so no sizes are exchanged.  Where the mesh names more than one
process, every process of the job must make the same call: one
`all_gather_object` of the calls' descriptions (shapes, dtype, radius
or parameters, the mesh), before any rows move, raises in every process
on a mismatch instead of leaving one blocked in a receive.

**Return values.**  The owner gets the whole result as one tensor on the
mesh's first entry's device; every other process gets None.  (The JAX
functions return a global array, whose addressable shards no process
can make whole without a gather.)  Where a block is shorter than the
halo radius (one neighbour cannot fill the halo) the JAX functions run
the single-device kernel, and so do these, on the owner's first entry
alone: `route` says which a call takes.

**One entry.**  A mesh whose 'rows' axis has a single entry has no
neighbours: every halo row would be an end block's replicated edge row,
the kernel's own clamp, and the overlay's zero rows feed only rows that
are cropped.  So such a call runs the single-device kernel on the image
where it lies: no padding, halo, overlay rows, crop or join
(fused_chain_spatial, process_spatial, median_spatial take the
single-device route; composite_spatial and warp_spatial return their one
block as it is; fused_chain_grid runs each 'batch' entry's slab
unextended and keeps its batch split).  A mesh of two or more 'rows'
entries runs the row split above, whatever devices and processes its
entries name.

**Spans and counters** (utils/profiling: spans only while a torch
profiler records, as under the CLI's --trace-dir): `pfe.spatial.check`
(the call's arguments and `_checked`), `pfe.spatial.scatter` (padding and
the blocks' uploads), `pfe.spatial.halo`, `pfe.spatial.overlay` (the
overlay's zero rows), `pfe.spatial.gather` and `pfe.spatial.join`; the
kernels' own spans lie between them.  Each step but the check counts the
bytes it copies in `spatial.copy_bytes.<step>`: what it writes into a
new tensor (a cat's output, never the small rows that feed it), moves to
another device or to the host, or receives from another process; a view,
and a move to the device a tensor already lies on, count 0.  Each call
counts the route it takes in `spatial.route.<route>`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from paintfe_tpu_torch.ops.kernels import as_u8_tensor as _u8, host_values
from paintfe_tpu_torch.parallel.distributed import global_batch_mesh, rank, world_size
from paintfe_tpu_torch.parallel.mesh import Mesh, NamedSharding, to_device
from paintfe_tpu_torch.utils.profiling import count, span


def _entries(devices) -> tuple:
    """The entries a mesh is built from, and their processes: by default
    every process's cards in rank order (global_batch_mesh: this process's
    cards in a single process; raises without a card); a Mesh's entries
    with its process indices; else the devices given, owned by this
    process."""
    if devices is None:
        devices = global_batch_mesh()
    if isinstance(devices, Mesh):
        return list(devices.devices.flat), list(devices.process_indices.flat)
    devices = list(devices)
    return devices, [rank()] * len(devices)


def rows_mesh(devices=None) -> Mesh:
    """1-D mesh over the row axis of a single image: by default every
    process's cards (jax.devices() is global too); `devices` may be a list
    of devices of this process (entries may repeat a device) or a Mesh,
    whose entries keep their processes, so rows_mesh(
    distributed.global_batch_mesh(local)) spans the job."""
    devices, procs = _entries(devices)
    return Mesh(devices, ("rows",), procs)


def rows_sharding(mesh: Mesh) -> NamedSharding:
    """[H, W, 4] image split by rows."""
    return NamedSharding(mesh, ("rows", None, None))


def grid_mesh(n_batch: int, n_rows: int, devices=None) -> Mesh:
    """2-D mesh ('batch', 'rows'): data parallelism over images x spatial
    parallelism within each image — the layout for batches of canvases too
    large for one card's fused-f32 appetite.  The first n_batch * n_rows
    entries of `devices` (as rows_mesh takes them) fill it row by row, so
    over global_batch_mesh(local), grid_mesh(processes, len(local)) gives
    each process one 'batch' row (halos inside a process, only the gather
    across) and grid_mesh(1, processes * len(local)) splits every image's
    rows across processes."""
    devices, procs = _entries(devices)
    k = n_batch * n_rows
    if len(devices) < k:
        raise ValueError(f"need {k} devices, have {len(devices)}")
    grid = np.array(devices[:k], dtype=object).reshape(n_batch, n_rows)
    return Mesh(grid, ("batch", "rows"), np.reshape(procs[:k], (n_batch, n_rows)))


def route(h: int, n: int, r: int) -> str:
    """The route a call takes with an image of h rows over n 'rows'
    entries and a halo of r rows: "single-device" when n is 1 (the kernel
    on the image where it lies) or when a block (h padded to a multiple
    of n, over n) is shorter than r, since one neighbour's block cannot
    fill the halo; else "sharded"."""
    return "single-device" if n == 1 or (h + (-h) % n) // n < r else "sharded"


def _counted(way: str) -> str:
    """`way`, a call's route, counted as `spatial.route.<way>`."""
    count(f"spatial.route.{way}")
    return way


def _checked(mesh: Optional[Mesh], *call) -> Mesh:
    """The mesh a spatial call runs on (rows_mesh() by default), checked:
    every entry's process is one of the job's; where the mesh names more
    than one process, every process of the job agrees on the call
    (`call`: its name, shapes, dtype, radius or parameters; the mesh is
    added), one all_gather_object before any rows move.  A mismatch
    raises in every process."""
    mesh = mesh if mesh is not None else rows_mesh()
    procs = sorted(set(mesh.process_indices.ravel().tolist()))
    if procs[0] < 0 or procs[-1] >= world_size():
        raise ValueError(f"spatial: the mesh names processes {procs}, outside a job of "
                         f"{world_size()} process(es)")
    if len(procs) > 1:
        mine = call + (mesh.axis_names, mesh.devices.shape,
                       [str(d) for d in mesh.devices.flat], mesh.process_indices.ravel().tolist())
        every = [None] * world_size()
        dist.all_gather_object(every, mine)
        if any(c != mine for c in every):
            raise ValueError("spatial: the processes disagree on the call: "
                             + "; ".join(f"process {p}: {c}" for p, c in enumerate(every)))
    return mesh


def _first(mesh: Mesh) -> torch.device:
    return mesh.devices.flat[0]


def _owner(mesh: Mesh) -> bool:
    """Whether this process owns the mesh's first entry (and the result)."""
    return int(mesh.process_indices.flat[0]) == rank()


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _copied(step: str, t: torch.Tensor) -> torch.Tensor:
    """`t`, a tensor that `step` wrote, its bytes counted as that step's."""
    count(f"spatial.copy_bytes.{step}", t.numel() * t.element_size())
    return t


def _moved(step: str, t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """to_device(t, device), its bytes counted as `step`'s where it moves."""
    out = to_device(t, device)
    return out if out is t else _copied(step, out)


def _scatter(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` uploaded to `device` as a block (itself where it lies there)."""
    with span("pfe.spatial.scatter"):
        return _moved("scatter", t, device)


def _edge_pad(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Pad `axis` to a multiple of n by replicating its last row."""
    pad = (-x.shape[axis]) % n
    if not pad:
        return x
    with span("pfe.spatial.scatter"):
        last = x.narrow(axis, x.shape[axis] - 1, 1)
        return _copied("scatter", torch.cat(
            [x, last.repeat(*[pad if d == axis else 1 for d in range(x.dim())])], dim=axis))


def _halo_extend(block: torch.Tensor, r: int, up: Optional[torch.Tensor],
                 down: Optional[torch.Tensor], axis: int = 0) -> torch.Tensor:
    """`block` with r rows of halo at each end of `axis`, on its device:
    the last r rows of `up` (the block above) and the first r rows of
    `down` (the block below), each copied from its device; an end block
    (no neighbour) replicates its own edge row, the single-device edge
    clamp."""
    with span("pfe.spatial.halo"):
        reps = [r if d == axis else 1 for d in range(block.dim())]
        n = block.shape[axis]
        top = (_moved("halo", up.narrow(axis, up.shape[axis] - r, r), block.device)
               if up is not None else block.narrow(axis, 0, 1).repeat(*reps))
        bottom = (_moved("halo", down.narrow(axis, 0, r), block.device)
                  if down is not None else block.narrow(axis, n - 1, 1).repeat(*reps))
        return _copied("halo", torch.cat([top, block, bottom], dim=axis))


def _zero_extend(block: torch.Tensor, r: int, axis: int = 0) -> torch.Tensor:
    """`block` with r zero rows at each end of `axis` (the overlay's halo:
    the rows whose results are cropped)."""
    with span("pfe.spatial.overlay"):
        shape = list(block.shape)
        shape[axis] = r
        zeros = block.new_zeros(shape)
        return _copied("overlay", torch.cat([zeros, block, zeros], dim=axis))


def _crop(t: torch.Tensor, r: int, axis: int = 0) -> torch.Tensor:
    return t.narrow(axis, r, t.shape[axis] - 2 * r) if r else t


def _join(parts, device: torch.device, h: int, axis: int = 0) -> torch.Tensor:
    """The blocks' results joined along `axis` on `device`, cropped to h;
    a single part is moved there, not copied where it lies there."""
    with span("pfe.spatial.join"):
        if len(parts) == 1:
            out = _moved("join", parts[0], device)
        else:
            out = _copied("join", torch.cat([_moved("join", p, device) for p in parts],
                                            dim=axis))
    return out.narrow(axis, 0, h) if out.shape[axis] != h else out


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous on the host, as gloo sends it: through a pinned
    buffer from a card."""
    if t.device.type == "cpu":
        host = t.contiguous()
        return host if host is t else _copied("gather", host)
    return _copied("gather", torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t))


class _Gather:
    """The gather of every entry's block result (each of `shape`, u8) to
    the owner, the process of the mesh's first entry.  Made before the
    kernels run: the owner posts one irecv a block of another process
    then, into pinned host buffers where the result goes to a card."""

    def __init__(self, mesh: Mesh, shape):
        self.procs = mesh.process_indices.ravel().tolist()
        self.owner, self.first = self.procs[0], _first(mesh)
        self.shape = tuple(shape)
        self.recvs = {}
        if rank() == self.owner:
            pin = self.first.type == "cuda"
            with span("pfe.spatial.gather"):
                for i, p in enumerate(self.procs):
                    if p != self.owner:
                        buf = torch.empty(self.shape, dtype=torch.uint8, pin_memory=pin)
                        self.recvs[i] = (buf, dist.irecv(buf, src=p, tag=i))

    def finish(self, outs: dict) -> Optional[list]:
        """`outs`, this process's results by flat entry index: on the
        owner, every entry's result in flat order, those of other
        processes uploaded to the first entry's device; elsewhere the
        results are sent to the owner, and None."""
        for i, t in outs.items():
            if tuple(t.shape) != self.shape or t.dtype != torch.uint8:
                raise ValueError(f"spatial: entry {i}'s result is {t.dtype} "
                                 f"{tuple(t.shape)}, expected u8 {self.shape}")
        with span("pfe.spatial.gather"):
            if rank() != self.owner:
                sent = []  # (host buffer, its send): each buffer lives until its send ends
                for i, t in outs.items():
                    host = _to_host(t)
                    sent.append((host, dist.isend(host, dst=self.owner, tag=i)))
                for _, work in sent:
                    work.wait()
                return None
            for i, (buf, work) in self.recvs.items():
                work.wait()
                outs[i] = _moved("gather", _copied("gather", buf), self.first)
            return [outs[i] for i in range(len(self.procs))]


def _mine(mesh: Mesh) -> list:
    """This process's entries: (flat index, device)."""
    me = rank()
    return [(i, d) for i, (d, p) in enumerate(zip(mesh.devices.flat,
                                                  mesh.process_indices.flat)) if p == me]


def _row_blocks(img: torch.Tensor, mesh: Mesh, r: int, fn: Callable,
                overlay: Optional[torch.Tensor] = None, axis: int = 0) -> dict:
    """fn over this process's entries' halo-extended blocks of the image,
    edge-padded and split along `axis` over the 1-D mesh; with an
    overlay, fn(block, overlay block) where the overlay is split the same
    way and its halo rows are zeros (their results are cropped).  A halo
    from an entry of this process is copied from its block; one from an
    entry of another process is the same rows of `img`.  Returns each
    result cropped by r rows at both ends of `axis`, by entry index."""
    n = mesh.size
    padded = _edge_pad(img, n, axis)
    ov = _edge_pad(overlay, n, axis) if overlay is not None else None
    hb = padded.shape[axis] // n

    def rows(t, j):
        return t.narrow(axis, j * hb, hb)

    mine = _mine(mesh)
    blocks = {j: _scatter(rows(padded, j), d) for j, d in mine}
    outs = {}
    for j, d in mine:
        args = [blocks[j]]
        if r:
            up = blocks.get(j - 1, rows(padded, j - 1)) if j > 0 else None
            down = blocks.get(j + 1, rows(padded, j + 1)) if j < n - 1 else None
            args = [_halo_extend(blocks[j], r, up, down, axis=axis)]
        if ov is not None:
            ov_block = _scatter(rows(ov, j), d)
            args.append(_zero_extend(ov_block, r, axis) if r else ov_block)
        outs[j] = _crop(fn(*args), r, axis)
    return outs


def _run_rows(img: torch.Tensor, mesh: Mesh, r: int, fn: Callable,
              overlay: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """_row_blocks over the rows of the image, gathered and cropped to its
    height on the owner; None elsewhere."""
    h = img.shape[0]
    gather = _Gather(mesh, (-(-h // mesh.size),) + tuple(img.shape[1:]))
    parts = gather.finish(_row_blocks(img, mesh, r, fn, overlay))
    return None if parts is None else _join(parts, _first(mesh), h)


def _describe(t: torch.Tensor) -> tuple:
    return tuple(t.shape), str(t.dtype)


def process_spatial(img, fn: Callable, mesh: Optional[Mesh] = None, *, halo: int):
    """Run `fn(image) -> image` on one image with its rows split over the
    mesh, each entry calling fn on its block extended by `halo` rows at
    both ends (the halo exchange), then cropping.

    `halo` is how many rows fn reads beyond a block on each side: a blur's
    tap radius, or the sum of the radii along a chain.  The result equals
    fn(img) when fn reads at most `halo` rows on each side and clamps at
    the image's edges, as every blur of the port does, and returns u8 of
    its input's shape.  (The JAX function leans on XLA's SPMD partitioner
    to insert the halos for any fn; torch has no partitioner, so the
    caller states the halo.  It is keyword-only with no default: a
    missing halo is an error, never a wrong image.)  A one-entry mesh,
    and blocks shorter than `halo`, take the single-device route: fn on
    the whole image on the first entry.  Returns a tensor on the first
    entry's device in the process that owns it, None in every other
    process."""
    r = int(halo)
    if r < 0:
        raise ValueError(f"process_spatial: halo {halo} < 0")
    with span("pfe.spatial.check"):
        img = _u8(img)
        mesh = _checked(mesh, "process_spatial", _describe(img), r)
    if _counted(route(img.shape[0], mesh.size, r)) == "single-device":
        return fn(_scatter(img, _first(mesh))) if _owner(mesh) else None
    return _run_rows(img, mesh, r, fn)


def composite_spatial(layers, modes, opacities, mesh: Optional[Mesh] = None):
    """Flatten a layer stack whose rows are split over the mesh: each entry
    folds its [N, hb, W, 4] block with the static compositor (K-composite;
    pointwise, so no halo).  H is padded with zero rows, which are cropped.
    On a one-entry mesh the one block's result is returned as it is.
    `layers` is u8 [N, H, W, 4] (tensor or array).  Returns the flattened
    image on the first entry's device in the process that owns it, None
    in every other process."""
    from paintfe_tpu_torch.core.composite import composite_stack_static

    with span("pfe.spatial.check"):
        layers = _u8(layers)
        mesh = _checked(mesh, "composite_spatial", _describe(layers),
                        host_values(modes, np.int64), host_values(opacities, np.float32))
    h = layers.shape[1]
    _counted(route(h, mesh.size, 0))
    pad = (-h) % mesh.size
    if pad:
        with span("pfe.spatial.scatter"):
            layers = _copied("scatter", torch.cat([layers, layers.new_zeros(
                (layers.shape[0], pad) + tuple(layers.shape[2:]))], dim=1))
    hb = layers.shape[1] // mesh.size
    gather = _Gather(mesh, (hb,) + tuple(layers.shape[2:]))
    outs = {i: composite_stack_static(_scatter(layers.narrow(1, i * hb, hb), d),
                                      modes, opacities)
            for i, d in _mine(mesh)}
    parts = gather.finish(outs)
    return None if parts is None else _join(parts, _first(mesh), h)


def _chain_radius(params) -> int:
    from paintfe_tpu_torch.ops.filters import gaussian_kernel

    return (gaussian_kernel(float(params.get("sigma", 2.0))).shape[0] - 1) // 2


def fused_chain_spatial(img, overlay, mesh: Optional[Mesh] = None, **params):
    """The headline fused chain (ops/fused_chain.fused_chain_kernel) over a
    row-split mesh: each entry takes its block with r halo rows from its
    neighbours (r, the blur's tap radius), runs K-chain on it and crops —
    the shard, exchange-halos, compute-locally recipe applied to an image
    kernel.  The overlay's halo rows are zeros (their results are
    cropped).  A one-entry mesh runs K-chain on the image where it lies.
    Equal to the single-device kernel, byte for byte, on the
    first entry's device in the process that owns it; None in every
    other process."""
    from paintfe_tpu_torch.ops.fused_chain import fused_chain_kernel

    with span("pfe.spatial.check"):
        img, overlay = _u8(img), _u8(overlay)
        mesh = _checked(mesh, "fused_chain_spatial", _describe(img), _describe(overlay),
                        sorted(params.items()))
        r = _chain_radius(params)
    if _counted(route(img.shape[0], mesh.size, r)) == "single-device":
        if not _owner(mesh):
            return None
        first = _first(mesh)
        return fused_chain_kernel(_scatter(img, first), _scatter(overlay, first), **params)
    return _run_rows(img, mesh, r, lambda block, ov: fused_chain_kernel(block, ov, **params),
                     overlay)


def fused_chain_grid(imgs, overlays, mesh: Mesh, **params):
    """The headline fused chain over a batch of images on the 2-D
    ('batch', 'rows') mesh: images split over 'batch', each image's rows
    over 'rows' with the halo exchange between 'rows' neighbours (the
    whole local batch slab in one copy), then K-chain once per local
    image.  With one 'rows' entry each 'batch' entry runs its slab
    unextended (no halo, crop or one-block join).  Equal to
    fused_chain_kernel per image on one device, stacked on the first
    entry's device in the process that owns it; None in every other
    process.  B must divide by the batch axis."""
    from paintfe_tpu_torch.ops.fused_chain import fused_chain_kernel

    with span("pfe.spatial.check"):
        imgs, overlays = _u8(imgs), _u8(overlays)
        mesh = _checked(mesh, "fused_chain_grid", _describe(imgs), _describe(overlays),
                        sorted(params.items()))
        r = _chain_radius(params)
    nb, nr = mesh.shape["batch"], mesh.shape["rows"]
    b, h = imgs.shape[0], imgs.shape[1]
    if b % nb != 0:
        raise ValueError(f"batch {b} not divisible by mesh batch axis {nb}")
    first = _first(mesh)
    # the whole batch on the first entry: a one-entry mesh, or blocks too
    # short for the halo; one 'rows' entry under a 'batch' split keeps the
    # split, each image on the single-device route of its own entry
    if _counted(route(h, nr, r)) == "single-device" and (nr > 1 or nb == 1):
        if not _owner(mesh):
            return None
        return torch.stack([fused_chain_kernel(_scatter(imgs[i], first),
                                               _scatter(overlays[i], first), **params)
                            for i in range(b)])
    per = b // nb
    r = r if nr > 1 else 0

    def chain(slab, ov):  # K-chain once per local image
        return torch.stack([fused_chain_kernel(slab[j], ov[j], **params)
                            for j in range(slab.shape[0])])

    gather = _Gather(mesh, (per, -(-h // nr)) + tuple(imgs.shape[2:]))
    outs = {}
    for k in range(nb):
        row = Mesh(mesh.devices[k], ("rows",), mesh.process_indices[k])
        blocks = _row_blocks(imgs[k * per:(k + 1) * per], row, r, chain,
                             overlays[k * per:(k + 1) * per], axis=1)
        outs.update({k * nr + j: t for j, t in blocks.items()})
    parts = gather.finish(outs)
    if parts is None:
        return None
    joined = [_join(parts[k * nr:(k + 1) * nr], first, h, axis=1) for k in range(nb)]
    with span("pfe.spatial.join"):
        return _copied("join", torch.cat(joined))


def median_spatial(img, r: int, mesh: Optional[Mesh] = None):
    """Window median of one row-split image on the mesh: each entry runs
    K-median on its block extended by r halo rows and crops; equal to
    ops/kernels.median_kernel on one device, on the first entry's device
    in the process that owns it (None in every other process).  r <= 0,
    a one-entry mesh and blocks shorter than r take the single-device route
    (median_kernel on the first entry, which refuses r < 1 as the port's
    K-median does)."""
    from paintfe_tpu_torch.ops.kernels import median_kernel

    with span("pfe.spatial.check"):
        img = _u8(img)
        r = int(r)
        mesh = _checked(mesh, "median_spatial", _describe(img), r)
    way = "single-device" if r <= 0 else route(img.shape[0], mesh.size, r)
    if _counted(way) == "single-device":
        return median_kernel(_scatter(img, _first(mesh)), r) if _owner(mesh) else None
    return _run_rows(img, mesh, r, lambda block: median_kernel(block, r))


def warp_spatial(src, sx, sy, mode: str = "zero", mesh: Optional[Mesh] = None):
    """Bilinear warp gather (ops/warp_kernel.gather_bilinear_u8 semantics)
    with the coordinate field row-split over the mesh: the whole source on
    every entry's device (a warp gathers from arbitrary rows; each process
    uploads its own copy to its entries' devices), each entry running
    K-warp on its rows of the field.  Returns the u8 [H, W, 4] result on
    the first entry's device in the process that owns it, None in every
    other process.

    Never returns None for an infeasible field, unlike the JAX function,
    whose TPU planner may find one: K-warp gathers any field, so there is
    no planner.  H is padded (by replicating the field's last row) to a
    multiple of the mesh size, not of n times the Pallas tile height.  On
    a one-entry mesh the one block's result is returned as it is."""
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8

    with span("pfe.spatial.check"):
        src, sx, sy = _u8(src), _f32(sx), _f32(sy)
        mesh = _checked(mesh, "warp_spatial", _describe(src), _describe(sx), _describe(sy),
                        str(mode))
    h, w = sx.shape
    n = mesh.size
    _counted(route(h, n, 0))
    mine = _mine(mesh)
    sources = {d: _scatter(src, d) for d in {d for _, d in mine}}  # one copy a device
    sxp, syp = _edge_pad(sx, n, 0), _edge_pad(sy, n, 0)
    hb = sxp.shape[0] // n
    gather = _Gather(mesh, (hb, w, 4))
    outs = {i: gather_bilinear_u8(sources[d], _scatter(sxp.narrow(0, i * hb, hb), d),
                                  _scatter(syp.narrow(0, i * hb, hb), d), mode)
            for i, d in mine}
    parts = gather.finish(outs)
    return None if parts is None else _join(parts, _first(mesh), h)
