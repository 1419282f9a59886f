"""Spatial sharding: one huge canvas split across cards
(paintfe_tpu.parallel.spatial counterpart).

Batch sharding (parallel/pipeline.py) covers the many-images case; this
module covers the one-giant-image case (the reference clamps documents at
256 Mpix — src/canvas/tiled_image.rs:14-26 — which exceeds one card's
appetite for fused f32 intermediates).  The image's rows are split over a
mesh of this process's cards ('rows'):

- **the row split**: H is padded by edge replication to a multiple of the
  'rows' size, and each mesh entry holds one block of hb rows on its
  device (a view where the image already lies there);
- **the halo exchange** (`_halo_extend`): before a neighbourhood kernel,
  each block receives the last r rows of the block above and the first r
  rows of the block below, copied device to device; the end blocks
  replicate their own edge row, which is the single-device kernel's edge
  clamp, so cropping r rows at each end of every block's result gives the
  single-device bytes;
- **the per-block kernel calls**: each entry runs the same kernel as the
  single-device call on its (extended) block: K-chain, K-median, K-blur
  through a caller's `fn`, K-composite (pointwise: no halo) and K-warp
  (the whole source on every entry's device, the field row-split).
  Entries on one card run in turn on its current stream; entries on
  distinct cards overlap, since each launch goes to its tensor's card.

The result is one tensor on the first entry's device.  (The JAX functions
return a sharded array that np.asarray gathers.)  Where a block is
shorter than the halo radius (one neighbour cannot fill the halo) the JAX
functions run the single-device kernel, and so do these, on the first
entry: `route` says which a call takes.

A mesh whose entries belong to another process raises: a spatial mesh
across processes needs halos over torch.distributed send/recv, which this
module does not do.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from paintfe_tpu_torch.ops.kernels import as_u8_tensor as _u8
from paintfe_tpu_torch.parallel.mesh import (Mesh, NamedSharding, batch_mesh,
                                             replicated, to_device)


def rows_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the row axis of a single image; by default this
    process's cards (raises without a card).  Entries may repeat a
    device."""
    devices = list(devices) if devices is not None else list(batch_mesh().devices.flat)
    return Mesh(devices, ("rows",))


def rows_sharding(mesh: Mesh) -> NamedSharding:
    """[H, W, 4] image split by rows."""
    return NamedSharding(mesh, ("rows", None, None))


def grid_mesh(n_batch: int, n_rows: int,
              devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh ('batch', 'rows'): data parallelism over images x spatial
    parallelism within each image — the layout for batches of canvases too
    large for one card's fused-f32 appetite."""
    devices = list(devices) if devices is not None else list(batch_mesh().devices.flat)
    if len(devices) < n_batch * n_rows:
        raise ValueError(f"need {n_batch * n_rows} devices, have {len(devices)}")
    grid = np.array(devices[:n_batch * n_rows], dtype=object).reshape(n_batch, n_rows)
    return Mesh(grid, ("batch", "rows"))


def route(h: int, n: int, r: int) -> str:
    """The route of an image of h rows over n 'rows' entries with a halo
    of r rows: "single-device" when a block (h padded to a multiple of n,
    over n) is shorter than r, since one neighbour's block cannot fill
    the halo; else "sharded"."""
    return "single-device" if (h + (-h) % n) // n < r else "sharded"


def _local(mesh: Optional[Mesh]) -> Mesh:
    from paintfe_tpu_torch.parallel.distributed import rank

    mesh = mesh if mesh is not None else rows_mesh()
    if (mesh.process_indices != rank()).any():
        raise ValueError("spatial sharding runs on this process's devices only: "
                         "a mesh across processes needs halos over "
                         "torch.distributed send/recv, which is not ported")
    return mesh


def _first(mesh: Mesh) -> torch.device:
    return mesh.devices.flat[0]


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _edge_pad(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Pad `axis` to a multiple of n by replicating its last row."""
    pad = (-x.shape[axis]) % n
    if not pad:
        return x
    last = x.narrow(axis, x.shape[axis] - 1, 1)
    return torch.cat([x, last.repeat(*[pad if d == axis else 1 for d in range(x.dim())])],
                     dim=axis)


def _halo_extend(block: torch.Tensor, r: int, up: Optional[torch.Tensor],
                 down: Optional[torch.Tensor], axis: int = 0) -> torch.Tensor:
    """`block` with r rows of halo at each end of `axis`, on its device:
    the last r rows of `up` (the block above) and the first r rows of
    `down` (the block below), each copied from its device; an end block
    (no neighbour) replicates its own edge row, the single-device edge
    clamp."""
    reps = [r if d == axis else 1 for d in range(block.dim())]
    n = block.shape[axis]
    top = (to_device(up.narrow(axis, up.shape[axis] - r, r), block.device)
           if up is not None else block.narrow(axis, 0, 1).repeat(*reps))
    bottom = (to_device(down.narrow(axis, 0, r), block.device)
              if down is not None else block.narrow(axis, n - 1, 1).repeat(*reps))
    return torch.cat([top, block, bottom], dim=axis)


def _zero_extend(block: torch.Tensor, r: int, axis: int = 0) -> torch.Tensor:
    """`block` with r zero rows at each end of `axis` (the overlay's halo:
    the rows whose results are cropped)."""
    shape = list(block.shape)
    shape[axis] = r
    zeros = block.new_zeros(shape)
    return torch.cat([zeros, block, zeros], dim=axis)


def _crop(t: torch.Tensor, r: int, axis: int = 0) -> torch.Tensor:
    return t.narrow(axis, r, t.shape[axis] - 2 * r) if r else t


def _gather(parts, device: torch.device, h: int, axis: int = 0) -> torch.Tensor:
    """The blocks' results joined along `axis` on `device`, cropped to h."""
    out = torch.cat([to_device(p, device) for p in parts], dim=axis)
    return out.narrow(axis, 0, h) if out.shape[axis] != h else out


def _neighbours(blocks, i):
    return (blocks[i - 1] if i > 0 else None,
            blocks[i + 1] if i < len(blocks) - 1 else None)


def _run_rows(img: torch.Tensor, mesh: Mesh, r: int, fn: Callable,
              overlay: Optional[torch.Tensor] = None, axis: int = 0) -> torch.Tensor:
    """fn over each entry's halo-extended block of the image, edge-padded
    and split along `axis` over the mesh's one axis; with an overlay,
    fn(block, overlay block) where the overlay is split the same way and
    its halo rows are zeros (their results are cropped).  Each result is
    cropped by r rows at both ends of `axis`, and the results are
    gathered and cropped to the image's extent on the first entry's
    device."""
    h = img.shape[axis]
    sharding = NamedSharding(mesh, (None,) * axis + (mesh.axis_names[0],))
    blocks = list(sharding.place(_edge_pad(img, mesh.size, axis)).flat)
    ovs = (list(sharding.place(_edge_pad(overlay, mesh.size, axis)).flat)
           if overlay is not None else None)
    outs = []
    for i, block in enumerate(blocks):
        args = [_halo_extend(block, r, *_neighbours(blocks, i), axis=axis) if r else block]
        if ovs is not None:
            args.append(_zero_extend(ovs[i], r, axis) if r else ovs[i])
        outs.append(_crop(fn(*args), r, axis))
    return _gather(outs, _first(mesh), h, axis)


def process_spatial(img, fn: Callable, mesh: Optional[Mesh] = None, *, halo: int):
    """Run `fn(image) -> image` on one image with its rows split over the
    mesh, each entry calling fn on its block extended by `halo` rows at
    both ends (the halo exchange), then cropping.

    `halo` is how many rows fn reads beyond a block on each side: a blur's
    tap radius, or the sum of the radii along a chain.  The result equals
    fn(img) when fn reads at most `halo` rows on each side and clamps at
    the image's edges, as every blur of the port does.  (The JAX function
    leans on XLA's SPMD partitioner to insert the halos for any fn; torch
    has no partitioner, so the caller states the halo.  It is keyword-only
    with no default: a missing halo is an error, never a wrong image.)
    Blocks shorter than `halo` take the single-device route: fn on the
    whole image on the first entry.  Returns a tensor on the first entry's
    device."""
    mesh = _local(mesh)
    r = int(halo)
    if r < 0:
        raise ValueError(f"process_spatial: halo {halo} < 0")
    img = _u8(img)
    if route(img.shape[0], mesh.size, r) == "single-device":
        return fn(to_device(img, _first(mesh)))
    return _run_rows(img, mesh, r, fn)


def composite_spatial(layers, modes, opacities, mesh: Optional[Mesh] = None):
    """Flatten a layer stack whose rows are split over the mesh: each entry
    folds its [N, hb, W, 4] block with the static compositor (K-composite;
    pointwise, so no halo).  H is padded with zero rows, which are cropped.
    `layers` is u8 [N, H, W, 4] (tensor or array)."""
    from paintfe_tpu_torch.core.composite import composite_stack_static

    mesh = _local(mesh)
    layers = _u8(layers)
    h = layers.shape[1]
    pad = (-h) % mesh.size
    if pad:
        layers = torch.cat([layers, layers.new_zeros(
            (layers.shape[0], pad) + tuple(layers.shape[2:]))], dim=1)
    blocks = NamedSharding(mesh, (None, "rows", None, None)).place(layers)
    outs = [composite_stack_static(b, modes, opacities) for b in blocks.flat]
    return _gather(outs, _first(mesh), h)


def fused_chain_spatial(img, overlay, mesh: Optional[Mesh] = None, **params):
    """The headline fused chain (ops/fused_chain.fused_chain_kernel) over a
    row-split mesh: each entry takes its block with r halo rows from its
    neighbours (r, the blur's tap radius), runs K-chain on it and crops —
    the shard, exchange-halos, compute-locally recipe applied to an image
    kernel.  The overlay's halo rows are zeros (their results are
    cropped).  Equal to the single-device kernel, byte for byte."""
    from paintfe_tpu_torch.ops.filters import gaussian_kernel
    from paintfe_tpu_torch.ops.fused_chain import fused_chain_kernel

    mesh = _local(mesh)
    r = (gaussian_kernel(float(params.get("sigma", 2.0))).shape[0] - 1) // 2
    img, overlay = _u8(img), _u8(overlay)
    h = img.shape[0]
    if route(h, mesh.size, r) == "single-device":
        first = _first(mesh)
        return fused_chain_kernel(to_device(img, first), to_device(overlay, first), **params)
    return _run_rows(img, mesh, r, lambda block, ov: fused_chain_kernel(block, ov, **params),
                     overlay)


def fused_chain_grid(imgs, overlays, mesh: Mesh, **params):
    """The headline fused chain over a batch of images on the 2-D
    ('batch', 'rows') mesh: images split over 'batch', each image's rows
    over 'rows' with the halo exchange between 'rows' neighbours (the
    whole local batch slab in one copy), then K-chain once per local
    image.  Equal to fused_chain_kernel per image on one device.  B must
    divide by the batch axis."""
    from paintfe_tpu_torch.ops.filters import gaussian_kernel
    from paintfe_tpu_torch.ops.fused_chain import fused_chain_kernel

    mesh = _local(mesh)
    nb, nr = mesh.shape["batch"], mesh.shape["rows"]
    r = (gaussian_kernel(float(params.get("sigma", 2.0))).shape[0] - 1) // 2
    imgs, overlays = _u8(imgs), _u8(overlays)
    b, h = imgs.shape[0], imgs.shape[1]
    if b % nb != 0:
        raise ValueError(f"batch {b} not divisible by mesh batch axis {nb}")
    first = _first(mesh)
    if route(h, nr, r) == "single-device":
        return torch.stack([fused_chain_kernel(to_device(imgs[i], first),
                                               to_device(overlays[i], first), **params)
                            for i in range(b)])
    per = b // nb

    def chain(slab, ov):  # K-chain once per local image
        return torch.stack([fused_chain_kernel(slab[j], ov[j], **params)
                            for j in range(slab.shape[0])])

    return torch.cat([
        to_device(_run_rows(imgs[k * per:(k + 1) * per],
                            Mesh(mesh.devices[k], ("rows",), mesh.process_indices[k]),
                            r, chain, overlays[k * per:(k + 1) * per], axis=1), first)
        for k in range(nb)])


def median_spatial(img, r: int, mesh: Optional[Mesh] = None):
    """Window median of one row-split image on the mesh: each entry runs
    K-median on its block extended by r halo rows and crops; equal to
    ops/kernels.median_kernel on one device.  r <= 0, and blocks shorter
    than r, take the single-device route (median_kernel on the first
    entry, which refuses r < 1 as the port's K-median does)."""
    from paintfe_tpu_torch.ops.kernels import median_kernel

    mesh = _local(mesh)
    img = _u8(img)
    r = int(r)
    if r <= 0 or route(img.shape[0], mesh.size, r) == "single-device":
        return median_kernel(to_device(img, _first(mesh)), r)
    return _run_rows(img, mesh, r, lambda block: median_kernel(block, r))


def warp_spatial(src, sx, sy, mode: str = "zero", mesh: Optional[Mesh] = None):
    """Bilinear warp gather (ops/warp_kernel.gather_bilinear_u8 semantics)
    with the coordinate field row-split over the mesh: the whole source on
    every entry's device (a warp gathers from arbitrary rows), each entry
    running K-warp on its rows of the field.

    Never returns None, unlike the JAX function, whose TPU planner may
    find a field infeasible: K-warp gathers any field, so there is no
    planner.  H is padded (by replicating the field's last row) to a
    multiple of the mesh size, not of n times the Pallas tile height."""
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8

    mesh = _local(mesh)
    src, sx, sy = _u8(src), _f32(sx), _f32(sy)
    h = sx.shape[0]
    sources = replicated(mesh).place(src)
    field = NamedSharding(mesh, ("rows", None))
    sxs = field.place(_edge_pad(sx, mesh.size, 0))
    sys_ = field.place(_edge_pad(sy, mesh.size, 0))
    outs = [gather_bilinear_u8(s, x, y, mode)
            for s, x, y in zip(sources.flat, sxs.flat, sys_.flat)]
    return _gather(outs, _first(mesh), h)
