"""The port's spatial sharding (paintfe_tpu_torch.parallel.spatial) against
the JAX package's (paintfe_tpu.parallel.spatial), case for case with
tests/test_spatial.py: the JAX functions on conftest's eight forced CPU
devices, the port on an 8-entry CPU mesh (torch has one CPU device, so
the entries repeat it), tolerance 0.  Each port result is also held
against the port's own single-device call; every function also on
meshes of one, two and three entries, where one entry takes the
single-device route and copies nothing.  (tests/test_spatial.py's
4K case is marked slow there; chip_smoke.py runs the port at 16384x16384
on the card.)  A mesh naming a process the job does not have is refused;
meshes across real processes: tests/test_torch_spatial_processes.py.

The second half is the counterpart of tests/test_collective_evidence.py:
the batch path and the compositor copy no halo, and a sharded call
copies exactly 2(n - 1) blocks of r rows, counted by wrapping the port's
_halo_extend, also when the mesh is split over two processes (the halos
across the boundary then come from each process's own input).
"""

import jax
import numpy as np
import pytest
import torch

from paintfe_tpu.core import fixtures
from paintfe_tpu.ops import filters as jfilters
from paintfe_tpu.parallel import spatial as jspatial
from paintfe_tpu.parallel.pipeline import _bc_device as j_bc, _sepia_device as j_sepia
from paintfe_tpu_torch.ops import filters as tfilters
from paintfe_tpu_torch.ops import kernels as tkernels
from paintfe_tpu_torch.ops import fused_chain as tchain
from paintfe_tpu_torch.ops import warp_kernel as twarp
from paintfe_tpu_torch.parallel import pipeline as tpipe
from paintfe_tpu_torch.parallel import spatial as tspatial
from paintfe_tpu_torch.parallel.mesh import Mesh

CPU = torch.device("cpu")


def _jmesh8():
    return jspatial.rows_mesh(jax.devices()[:8])


def _tmesh8():
    return tspatial.rows_mesh([CPU] * 8)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _radius(sigma):
    return len(tfilters.gaussian_kernel(float(sigma))) // 2


@pytest.fixture
def calls(monkeypatch):
    """Counts each kernel's calls through the module attributes the spatial
    functions import at call time (a CPU tensor takes the plain version,
    which counts no launch)."""
    counts = {}

    def wrap(module, name):
        fn = getattr(module, name)

        def counted(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, counted)

    wrap(tchain, "fused_chain_kernel")
    wrap(tkernels, "median_kernel")
    wrap(twarp, "gather_bilinear_u8")
    wrap(tkernels, "composite_stack_kernel")
    import paintfe_tpu_torch.core.composite as tcomp
    monkeypatch.setattr(tcomp, "composite_stack_kernel", tkernels.composite_stack_kernel)
    return counts


@pytest.mark.parametrize("h,route", [(48, "single-device"), (96, "sharded")])
def test_spatial_blur_matches_single_device(h, route):
    """The JAX case (48 rows: blocks of 6 under the halo of 9, which XLA's
    partitioner handles and the port routes to one device) and a height
    whose blocks hold the halo."""
    img = np.asarray(fixtures.test_gradient(64, h))
    ref = np.asarray(jax.jit(lambda x: jfilters.gaussian_blur(x, 3.0))(img))
    jout = np.asarray(jspatial.process_spatial(
        img, lambda x: jfilters.gaussian_blur(x, 3.0), _jmesh8()))
    fn = lambda x: tfilters.gaussian_blur(x, 3.0)  # noqa: E731
    out = tspatial.process_spatial(img, fn, _tmesh8(), halo=_radius(3.0))
    assert tspatial.route(h, 8, _radius(3.0)) == route
    np.testing.assert_array_equal(jout, ref)
    np.testing.assert_array_equal(_np(out), ref)
    np.testing.assert_array_equal(_np(out), _np(fn(torch.from_numpy(img))))


@pytest.mark.parametrize("w,h", [(61, 40), (40, 61)])
def test_spatial_chain_and_ragged_height(w, h):
    """The JAX case (test_checkerboard(61, 40): 40 rows of 61) and the
    ragged height it names: H=61 not divisible by 8 -> edge-replicate pad
    + crop."""
    img = np.asarray(fixtures.test_checkerboard(w, h))

    def jchain(x):
        x = jfilters.gaussian_blur(x, 1.5)
        x = j_bc(x, 10.0, 20.0)
        return j_sepia(x, 0.5)

    def tchain_fn(x):
        x = tfilters.gaussian_blur(x, 1.5)
        x = tpipe._bc_device(x, 10.0, 20.0)
        return tpipe._sepia_device(x, 0.5)

    ref = np.asarray(jax.jit(jchain)(img))
    out = tspatial.process_spatial(img, tchain_fn, _tmesh8(), halo=_radius(1.5))
    np.testing.assert_array_equal(np.asarray(jspatial.process_spatial(img, jchain, _jmesh8())),
                                  ref)
    np.testing.assert_array_equal(_np(out), ref)
    assert out.shape == (h, w, 4)


def test_process_spatial_needs_its_halo():
    """The halo is keyword-only with no default (a missing halo is an error,
    never a wrong image), and a block shorter than it takes the
    single-device route."""
    img = torch.from_numpy(np.asarray(fixtures.test_gradient(24, 16)))
    fn = lambda x: tfilters.gaussian_blur(x, 3.0)  # noqa: E731
    with pytest.raises(TypeError):
        tspatial.process_spatial(img, fn, _tmesh8())  # noqa
    with pytest.raises(ValueError, match="halo"):
        tspatial.process_spatial(img, fn, _tmesh8(), halo=-1)
    assert tspatial.route(16, 8, _radius(3.0)) == "single-device"
    np.testing.assert_array_equal(_np(tspatial.process_spatial(img, fn, _tmesh8(),
                                                               halo=_radius(3.0))),
                                  _np(fn(img)))


def test_composite_spatial_matches(calls):
    from paintfe_tpu.core.composite import composite_stack_static as jcomposite
    from paintfe_tpu_torch.core.composite import composite_stack_static as tcomposite

    rng = np.random.default_rng(0)
    layers = rng.integers(0, 256, (5, 61, 40, 4), np.uint8)
    modes = (0, 8, 16, 3, 21)
    opac = np.array([1.0, 0.8, 0.5, 0.9, 0.7], np.float32)
    ref = np.asarray(jcomposite(layers, modes, opac))
    np.testing.assert_array_equal(
        np.asarray(jspatial.composite_spatial(layers, modes, opac, _jmesh8())), ref)
    out = tspatial.composite_spatial(layers, modes, opac, _tmesh8())
    np.testing.assert_array_equal(_np(out), ref)
    np.testing.assert_array_equal(_np(tcomposite(torch.from_numpy(layers), modes, opac)), ref)
    assert calls == {"composite_stack_kernel": 8 + 1}  # 8 blocks, then the whole


def test_fused_chain_spatial_matches_single_device(calls):
    from paintfe_tpu.ops.fused_chain import fused_chain as jfused

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (61, 80, 4), np.uint8)
    ov = rng.integers(0, 256, (61, 80, 4), np.uint8)
    ref = np.asarray(jax.jit(lambda a, b: jfused(a, b))(img, ov))
    np.testing.assert_array_equal(np.asarray(jspatial.fused_chain_spatial(img, ov, _jmesh8())),
                                  ref)
    out = tspatial.fused_chain_spatial(img, ov, _tmesh8())
    assert calls == {"fused_chain_kernel": 8}
    np.testing.assert_array_equal(_np(out), ref)
    single = tchain.fused_chain_kernel(torch.from_numpy(img), torch.from_numpy(ov))
    np.testing.assert_array_equal(_np(single), ref)


@pytest.mark.parametrize("h", [64, 61])
def test_median_spatial_matches_single_device(h, calls):
    from paintfe_tpu.ops.pallas_kernels import median_pallas

    rng = np.random.default_rng(7 + h)
    img = rng.integers(0, 256, (h, 40, 4), np.uint8)
    ref = np.asarray(median_pallas(img, 2))
    np.testing.assert_array_equal(np.asarray(jspatial.median_spatial(img, 2, _jmesh8())), ref)
    out = tspatial.median_spatial(img, 2, _tmesh8())
    assert calls == {"median_kernel": 8}
    np.testing.assert_array_equal(_np(out), ref)
    np.testing.assert_array_equal(_np(tkernels.median_kernel(torch.from_numpy(img), 2)), ref)


def _swirl(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # swirl-ish field with out-of-bounds excursions at the corners
    sx = xx + 3.0 * np.sin(yy / 9.0) - 1.5
    sy = yy + 2.0 * np.cos(xx / 7.0) + 0.75
    return sx, sy


@pytest.mark.parametrize("mode", ["zero", "clamp"])
def test_warp_spatial_matches_single_device(mode, calls):
    from paintfe_tpu.ops.warp_kernel import gather_bilinear_u8 as jgather

    rng = np.random.default_rng(9)
    h, w = 61, 50
    src = rng.integers(0, 256, (h, w, 4), np.uint8)
    sx, sy = _swirl(h, w)
    ref = np.asarray(jgather(src, sx, sy, mode=mode))
    jout = jspatial.warp_spatial(src, sx, sy, mode=mode, mesh=_jmesh8())
    np.testing.assert_array_equal(np.asarray(jout), ref)
    out = tspatial.warp_spatial(src, sx, sy, mode=mode, mesh=_tmesh8())
    assert calls == {"gather_bilinear_u8": 8}
    np.testing.assert_array_equal(_np(out), ref)
    single = twarp.gather_bilinear_u8(torch.from_numpy(src), torch.from_numpy(sx),
                                      torch.from_numpy(sy), mode)
    np.testing.assert_array_equal(_np(single), ref)


def test_spatial_tiny_image_fallback(calls):
    """Blocks shorter than the halo radius take the single-device route:
    one kernel call on the first entry, equal to the JAX route."""
    from paintfe_tpu.ops.fused_chain import fused_chain as jfused
    from paintfe_tpu.ops.pallas_kernels import median_pallas

    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (20, 40, 4), np.uint8)  # 20/8 = 2.5 < r=6
    ov = rng.integers(0, 256, (20, 40, 4), np.uint8)
    ref = np.asarray(jax.jit(lambda a, b: jfused(a, b))(img, ov))
    np.testing.assert_array_equal(np.asarray(jspatial.fused_chain_spatial(img, ov, _jmesh8())),
                                  ref)
    assert tspatial.route(20, 8, _radius(2.0)) == "single-device"
    np.testing.assert_array_equal(_np(tspatial.fused_chain_spatial(img, ov, _tmesh8())), ref)
    assert calls == {"fused_chain_kernel": 1}

    # 12 rows pad to 16: blocks of 2 rows hold the halo of r=2, so both
    # packages shard this one; 7 rows pad to 8, blocks of 1 < r=2: the
    # single-device route
    for h, shards in ((12, 8), (7, 1)):
        calls.clear()
        img2 = rng.integers(0, 256, (h, 40, 4), np.uint8)
        ref2 = np.asarray(median_pallas(img2, 2))
        np.testing.assert_array_equal(np.asarray(jspatial.median_spatial(img2, 2, _jmesh8())),
                                      ref2)
        np.testing.assert_array_equal(_np(tspatial.median_spatial(img2, 2, _tmesh8())), ref2)
        assert calls == {"median_kernel": shards}


@pytest.mark.parametrize("h", [64, 61])
def test_fused_chain_grid_2d_mesh(h, calls):
    from paintfe_tpu.ops.fused_chain import fused_chain as jfused

    rng = np.random.default_rng(17 + h)
    jmesh = jspatial.grid_mesh(2, 4, jax.devices()[:8])
    tmesh = tspatial.grid_mesh(2, 4, [CPU] * 8)
    assert tmesh.shape == {"batch": 2, "rows": 4}
    imgs = rng.integers(0, 256, (4, h, 80, 4), np.uint8)
    ovs = rng.integers(0, 256, (4, h, 80, 4), np.uint8)
    ref = np.stack([np.asarray(jax.jit(lambda a, b: jfused(a, b))(imgs[i], ovs[i]))
                    for i in range(4)])
    np.testing.assert_array_equal(np.asarray(jspatial.fused_chain_grid(imgs, ovs, jmesh)), ref)
    out = tspatial.fused_chain_grid(imgs, ovs, tmesh)
    assert calls == {"fused_chain_kernel": 4 * 4}  # each image once per rows entry
    np.testing.assert_array_equal(_np(out), ref)
    with pytest.raises(ValueError, match="not divisible"):
        tspatial.fused_chain_grid(imgs[:3], ovs[:3], tmesh)


SMALL_MESH_CALLS = ["process_spatial", "fused_chain_spatial", "median_spatial", "warp_spatial",
                    "composite_spatial", "fused_chain_grid"]


def _counted(fn):
    """fn()'s result and the spatial counters it moved, by name less
    `spatial.`."""
    from paintfe_tpu_torch.utils import profiling

    before = profiling.counts()
    out = fn()
    moved = {name[len("spatial."):]: n - before.get(name, 0)
             for name, n in profiling.counts().items()
             if name.startswith("spatial.") and n != before.get(name, 0)}
    return out, moved


@pytest.mark.parametrize("h", [61, 64])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("call", SMALL_MESH_CALLS)
def test_small_meshes_match_jax_and_one_device(call, n, h, calls):
    """Each spatial function on a mesh of n 'rows' entries (the grid on
    grid_mesh(1, n)) against the JAX function on n CPU devices and the
    port's single-device call, tolerance 0.  One entry takes the
    single-device route: one kernel call on the image where it lies, no
    byte copied; two and three entries shard, one call an entry."""
    from paintfe_tpu.core.composite import composite_stack_static as jcomposite
    from paintfe_tpu.ops.fused_chain import fused_chain as jfused
    from paintfe_tpu.ops.pallas_kernels import median_pallas
    from paintfe_tpu_torch.core.composite import composite_stack_static as tcomposite

    rng = np.random.default_rng(31 * n + h)
    w = 40
    img, ov = (torch.from_numpy(rng.integers(0, 256, (h, w, 4), np.uint8)) for _ in range(2))
    layers = torch.from_numpy(rng.integers(0, 256, (5, h, w, 4), np.uint8))
    imgs, ovs = (torch.from_numpy(rng.integers(0, 256, (2, h, w, 4), np.uint8))
                 for _ in range(2))
    sx, sy = (torch.from_numpy(a) for a in _swirl(h, w))
    modes, opac = (0, 8, 16, 3, 21), np.array([1.0, 0.8, 0.5, 0.9, 0.7], np.float32)
    jdev, tdev = jax.devices()[:n], [CPU] * n
    jmesh, tmesh = jspatial.rows_mesh(jdev), tspatial.rows_mesh(tdev)
    jgrid, tgrid = jspatial.grid_mesh(1, n, jdev), tspatial.grid_mesh(1, n, tdev)

    def blur(x):
        calls["blur"] = calls.get("blur", 0) + 1
        return tfilters.gaussian_blur(x, 3.0)

    a = {name: t.numpy() for name, t in (("img", img), ("ov", ov), ("layers", layers),
                                         ("imgs", imgs), ("ovs", ovs), ("sx", sx), ("sy", sy))}
    jax_call, port_call, single, kernel, r = {
        "process_spatial": (
            lambda: jspatial.process_spatial(a["img"], lambda x: jfilters.gaussian_blur(x, 3.0),
                                             jmesh),
            lambda: tspatial.process_spatial(img, blur, tmesh, halo=_radius(3.0)),
            lambda: blur(img), "blur", _radius(3.0)),
        "fused_chain_spatial": (
            lambda: jspatial.fused_chain_spatial(a["img"], a["ov"], jmesh),
            lambda: tspatial.fused_chain_spatial(img, ov, tmesh),
            lambda: tchain.fused_chain_kernel(img, ov), "fused_chain_kernel", _radius(2.0)),
        "median_spatial": (
            lambda: jspatial.median_spatial(a["img"], 2, jmesh),
            lambda: tspatial.median_spatial(img, 2, tmesh),
            lambda: tkernels.median_kernel(img, 2), "median_kernel", 2),
        "warp_spatial": (
            lambda: jspatial.warp_spatial(a["img"], a["sx"], a["sy"], mode="clamp", mesh=jmesh),
            lambda: tspatial.warp_spatial(img, sx, sy, mode="clamp", mesh=tmesh),
            lambda: twarp.gather_bilinear_u8(img, sx, sy, "clamp"), "gather_bilinear_u8", 0),
        "composite_spatial": (
            lambda: jspatial.composite_spatial(a["layers"], modes, opac, jmesh),
            lambda: tspatial.composite_spatial(layers, modes, opac, tmesh),
            lambda: tcomposite(layers, modes, opac), "composite_stack_kernel", 0),
        "fused_chain_grid": (
            lambda: jspatial.fused_chain_grid(a["imgs"], a["ovs"], jgrid),
            lambda: tspatial.fused_chain_grid(imgs, ovs, tgrid),
            lambda: torch.stack([tchain.fused_chain_kernel(imgs[i], ovs[i]) for i in range(2)]),
            "fused_chain_kernel", _radius(2.0)),
    }[call]
    want = _np(single())
    calls.clear()
    out, moved = _counted(port_call)
    per_call = 2 if call == "fused_chain_grid" else 1  # the grid's images
    way = tspatial.route(h, n, r)
    assert way == ("single-device" if n == 1 else "sharded")
    assert moved.pop(f"route.{way}") == 1
    if n == 1:
        assert moved == {}
    assert calls == {kernel: per_call * n}
    np.testing.assert_array_equal(_np(out), want)
    if call == "median_spatial":
        np.testing.assert_array_equal(want, np.asarray(median_pallas(a["img"], 2)))
    elif call == "fused_chain_spatial":
        np.testing.assert_array_equal(
            want, np.asarray(jax.jit(lambda x, y: jfused(x, y))(a["img"], a["ov"])))
    elif call == "composite_spatial":
        np.testing.assert_array_equal(want, np.asarray(jcomposite(a["layers"], modes, opac)))
    np.testing.assert_array_equal(_np(out), np.asarray(jax_call()))


@pytest.mark.parametrize("h", [61, 64])
def test_grid_with_one_rows_entry_keeps_its_batch_split(h, calls, monkeypatch):
    """fused_chain_grid on grid_mesh(4, 1): each 'batch' entry runs K-chain
    on its own image, unextended (no halo, overlay rows or scatter
    copies), and only the batch's four parts are joined; byte-equal to
    the JAX grid on grid_mesh(4, 1) and to the kernel image by image."""
    from paintfe_tpu.ops.fused_chain import fused_chain as jfused

    rng = np.random.default_rng(37 + h)
    w = 48
    imgs, ovs = (rng.integers(0, 256, (4, h, w, 4), np.uint8) for _ in range(2))
    tgrid = tspatial.grid_mesh(4, 1, [CPU] * 4)
    record = []
    inner = tspatial._row_blocks

    def blocks(slab, mesh, r, fn, overlay=None, axis=0):
        record.append((mesh.size, slab.shape[0], r))
        return inner(slab, mesh, r, fn, overlay, axis)
    monkeypatch.setattr(tspatial, "_row_blocks", blocks)
    out, moved = _counted(lambda: tspatial.fused_chain_grid(imgs, ovs, tgrid))
    assert record == [(1, 1, 0)] * 4  # one image an entry, no halo rows
    assert calls == {"fused_chain_kernel": 4}
    assert moved == {"route.single-device": 1, "copy_bytes.join": 4 * h * w * 4}
    ref = np.stack([np.asarray(jax.jit(lambda a, b: jfused(a, b))(imgs[i], ovs[i]))
                    for i in range(4)])
    jgrid = jspatial.grid_mesh(4, 1, jax.devices()[:4])
    np.testing.assert_array_equal(np.asarray(jspatial.fused_chain_grid(imgs, ovs, jgrid)), ref)
    np.testing.assert_array_equal(_np(out), ref)
    single = torch.stack([tchain.fused_chain_kernel(torch.from_numpy(imgs[i]),
                                                    torch.from_numpy(ovs[i])) for i in range(4)])
    np.testing.assert_array_equal(_np(single), ref)


def test_fused_chain_spatial_zero_sigma():
    """sigma=0 makes the blur a no-tap identity (halo radius 0): the sharded
    path copies no halo and crops nothing."""
    from paintfe_tpu.ops.fused_chain import fused_chain_kernel as jkernel

    rng = np.random.default_rng(23)
    img = rng.integers(0, 256, (64, 80, 4), np.uint8)
    ov = rng.integers(0, 256, (64, 80, 4), np.uint8)
    ref = np.asarray(jkernel(img, ov, sigma=0.0))
    np.testing.assert_array_equal(
        np.asarray(jspatial.fused_chain_spatial(img, ov, _jmesh8(), sigma=0.0)), ref)
    np.testing.assert_array_equal(
        _np(tspatial.fused_chain_spatial(img, ov, _tmesh8(), sigma=0.0)), ref)

    jmesh = jspatial.grid_mesh(2, 4, jax.devices()[:8])
    tmesh = tspatial.grid_mesh(2, 4, [CPU] * 8)
    imgs = rng.integers(0, 256, (2, 64, 80, 4), np.uint8)
    ovs = rng.integers(0, 256, (2, 64, 80, 4), np.uint8)
    refs = np.stack([np.asarray(jkernel(imgs[i], ovs[i], sigma=0.0)) for i in range(2)])
    np.testing.assert_array_equal(
        np.asarray(jspatial.fused_chain_grid(imgs, ovs, jmesh, sigma=0.0)), refs)
    np.testing.assert_array_equal(
        _np(tspatial.fused_chain_grid(imgs, ovs, tmesh, sigma=0.0)), refs)


@pytest.mark.parametrize("call", ["fused_chain_spatial", "median_spatial", "warp_spatial",
                                  "composite_spatial", "process_spatial", "fused_chain_grid"])
@pytest.mark.parametrize("procs", [[0, 1], [0, -1]])
def test_mesh_naming_a_process_outside_the_job_raises(call, procs):
    """A mesh whose entries name a process the job does not have (here a
    single process: index 1, or a negative index) is refused, by every
    spatial call, before any work."""
    cpu = torch.device("cpu")
    img = np.zeros((16, 8, 4), np.uint8)
    mesh = Mesh([cpu] * 2, ("rows",), procs)
    grid = Mesh([[cpu], [cpu]], ("batch", "rows"), [[p] for p in procs])
    run = {
        "fused_chain_spatial": lambda: tspatial.fused_chain_spatial(img, img, mesh),
        "median_spatial": lambda: tspatial.median_spatial(img, 1, mesh),
        "warp_spatial": lambda: tspatial.warp_spatial(img, np.zeros((16, 8), np.float32),
                                                      np.zeros((16, 8), np.float32),
                                                      mesh=mesh),
        "composite_spatial": lambda: tspatial.composite_spatial(img[None], (0,), (1.0,), mesh),
        "process_spatial": lambda: tspatial.process_spatial(img, lambda t: t, mesh, halo=0),
        "fused_chain_grid": lambda: tspatial.fused_chain_grid(img[None].repeat(2, 0),
                                                              img[None].repeat(2, 0), grid),
    }[call]
    with pytest.raises(ValueError, match=r"outside a job of 1 process"):
        run()


# -- the counterpart of tests/test_collective_evidence.py ----------------------


@pytest.fixture
def halos(monkeypatch):
    """Wraps spatial._halo_extend: records, per call, how many neighbour
    blocks of r rows it copied and the rows it returned."""
    record = []
    inner = tspatial._halo_extend

    def counted(block, r, up, down, axis=0):
        out = inner(block, r, up, down, axis)
        assert out.shape[axis] == block.shape[axis] + 2 * r
        record.append({"copied": (up is not None) + (down is not None), "r": r,
                       "row_bytes": out.numel() // out.shape[axis] * out.element_size()})
        return out
    monkeypatch.setattr(tspatial, "_halo_extend", counted)
    return record


def test_batch_path_copies_no_halo(halos):
    """The sharded CLI batch program: every image lies on one entry, so
    run_batch on the 8-entry mesh calls no halo exchange."""
    ops = [tpipe.PipelineOp("apply_blur", (1.5,)),
           tpipe.PipelineOp("apply_brightness_contrast", (10.0, 20.0)),
           tpipe.PipelineOp("apply_levels", (10.0, 245.0, 1.1)),
           tpipe.PipelineOp("apply_sepia", (0.5,)),
           tpipe.PipelineOp("apply_median", (1,))]
    images = np.random.default_rng(1).integers(0, 256, (8, 32, 32, 4), np.uint8)
    out = tpipe.run_batch(images, ops, Mesh([CPU] * 8, ("batch",)))
    assert halos == []
    np.testing.assert_array_equal(out, tpipe.run_batch(images, ops, "cpu"))


def test_batch_compositor_copies_no_halo(halos):
    rng = np.random.default_rng(2)
    layers = rng.integers(0, 256, (3, 16, 16, 4), np.uint8)
    tspatial.composite_spatial(layers, (0, 8, 16), (1.0, 0.8, 0.5), _tmesh8())
    assert halos == []


@pytest.mark.parametrize("sigma,w", [(2.0, 32), (4.0, 128)])
def test_spatial_path_moves_exactly_the_halos(sigma, w, halos):
    """fused_chain_spatial: the only copies between entries are the two
    r-row halos of each interior boundary, 2 (n - 1) blocks of r rows in
    all, u8 [r, W, 4] each, whatever the image height."""
    r = _radius(sigma)
    n = 8
    for h in (8 * max(r, 8), 8 * max(r, 8) * 3):
        halos.clear()
        img = np.random.default_rng(h).integers(0, 256, (h, w, 4), np.uint8)
        out = tspatial.fused_chain_spatial(img, img, _tmesh8(), sigma=sigma)
        assert len(halos) == n
        assert sum(c["copied"] for c in halos) == 2 * (n - 1)
        assert all(c["r"] == r and c["row_bytes"] == w * 4 for c in halos)
        assert sum(c["copied"] * c["r"] * c["row_bytes"] for c in halos) == \
            2 * (n - 1) * r * w * 4
        ref = tchain.fused_chain_kernel(torch.from_numpy(img), torch.from_numpy(img),
                                        sigma=sigma)
        np.testing.assert_array_equal(_np(out), _np(ref))


@pytest.mark.parametrize("sigma,w", [(2.0, 32), (4.0, 128)])
def test_cross_process_halos_come_from_the_local_input(sigma, w, monkeypatch):
    """The counterpart of test_spatial_path_moves_exactly_the_halos for a
    mesh split 4 + 4 over two processes: each process, acting as rank 0
    and then 1, extends only its own four blocks; together still 2 (n - 1)
    copies of r rows of u8 [W, 4].  The entries lie on "meta", so a halo
    copied from a neighbour block comes from meta, and one whose
    neighbour belongs to the other process comes from the local (CPU)
    input: exactly one on each side of the boundary."""
    r, n = _radius(sigma), 8
    mesh = Mesh([torch.device("meta")] * n, ("rows",), [0] * 4 + [1] * 4)
    img = torch.from_numpy(np.random.default_rng(w).integers(0, 256, (n * r * 3, w, 4),
                                                             np.uint8))
    record = []
    inner = tspatial._halo_extend

    def halo(block, r, up, down, axis=0):
        record.append((r, [t.device.type for t in (up, down) if t is not None]))
        return inner(block, r, up, down, axis)
    monkeypatch.setattr(tspatial, "_halo_extend", halo)
    sources = []
    for me in (0, 1):
        record.clear()
        monkeypatch.setattr(tspatial, "rank", lambda me=me: me)
        outs = tspatial._row_blocks(img, mesh, r, lambda b, ov: b, img)
        assert sorted(outs) == list(range(4 * me, 4 * me + 4))
        assert all(t.shape == (img.shape[0] // n, w, 4) for t in outs.values())
        assert all(hr == r for hr, _ in record)
        sources.append([s for _, s in record])
    assert sources == [[["meta"], ["meta", "meta"], ["meta", "meta"], ["meta", "cpu"]],
                       [["cpu", "meta"], ["meta", "meta"], ["meta", "meta"], ["meta"]]]
    assert sum(len(s) for p in sources for s in p) == 2 * (n - 1)


def test_spatial_median_moves_exactly_the_halos(halos):
    r = 2
    img = np.random.default_rng(5).integers(0, 256, (64, 32, 4), np.uint8)
    tspatial.median_spatial(img, r, _tmesh8())
    assert sum(c["copied"] for c in halos) == 2 * 7
    assert all(c["r"] == r and c["row_bytes"] == 32 * 4 for c in halos)


def test_grid_moves_the_halos_along_rows_only(halos):
    """fused_chain_grid on the 2x4 mesh: each 'batch' row of entries
    exchanges its slabs' halos along 'rows' only: 2 x 2 (4 - 1) copies of
    [b, r, W, 4]."""
    rng = np.random.default_rng(29)
    imgs = rng.integers(0, 256, (4, 64, 24, 4), np.uint8)
    tspatial.fused_chain_grid(imgs, imgs, tspatial.grid_mesh(2, 4, [CPU] * 8))
    assert len(halos) == 8
    assert sum(c["copied"] for c in halos) == 2 * 2 * 3
    assert all(c["r"] == _radius(2.0) for c in halos)
