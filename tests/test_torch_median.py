"""The port's median (ops/filters.median, ops/kernels.median_plain, the
K-median wrapper) against the JAX package's filters.median and its Pallas
median_pallas run in interpret mode, tolerance 0, on seeded inputs."""

import numpy as np
import pytest
import torch

from paintfe_tpu.ops import filters as jfilters
from paintfe_tpu.ops.pallas_kernels import median_pallas
from paintfe_tpu_torch.ops import filters as tfilters
from paintfe_tpu_torch.ops import kernels, median_network

# 37x53 and 45x131: neither a multiple of 8 rows nor of 128 columns
SHAPES = [(37, 53), (45, 131)]


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape + (4,), np.uint8)


def _mask(shape):
    m = np.zeros(shape, np.uint8)
    m[3:shape[0] - 5, 7:shape[1] // 2] = 255
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("r", [1, 2, 3])
def test_median_matches_jax(r, shape, masked):
    img = _img(shape, 10 + r)
    mask = _mask(shape) if masked else None
    ref = np.asarray(jfilters.median(img, r, mask))
    out = tfilters.median(torch.from_numpy(img), r, mask)
    assert out.dtype == torch.uint8 and out.shape == img.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("r", [1, 2, 3])
def test_median_plain_matches_median_pallas(r, shape):
    img = _img(shape, 20 + r)
    ref = np.asarray(median_pallas(img, r, interpret=True))
    np.testing.assert_array_equal(kernels.median_plain(torch.from_numpy(img), r).numpy(), ref)


@pytest.mark.parametrize("radius", [0, -3])
def test_radius_below_one_is_one(radius):
    img = _img((12, 17), 3)
    np.testing.assert_array_equal(
        tfilters.median(torch.from_numpy(img), radius).numpy(),
        np.asarray(jfilters.median(img, radius)))


def test_batch_equals_each_image():
    batch = np.stack([_img((21, 34), s) for s in range(3)])
    out = tfilters.median(torch.from_numpy(batch), 2).numpy()
    for k in range(3):
        np.testing.assert_array_equal(out[k], np.asarray(jfilters.median(batch[k], 2)))


@pytest.mark.parametrize("k2", [9, 25, 49, 81, 121])
def test_layered_network_selects_the_median(k2):
    """The pruned Batcher network, run one layer of disjoint comparators at
    a time, leaves the exact median at k2 // 2."""
    rng = np.random.default_rng(k2)
    vals = rng.integers(0, 256, (k2, 500)).astype(np.int32)
    work = vals.copy()
    for lo, hi in kernels._median_layers(k2):
        assert not set(lo) & set(hi) and len(set(lo + hi)) == 2 * len(lo)
        a, b = work[lo], work[hi]
        work[lo], work[hi] = np.minimum(a, b), np.maximum(a, b)
    np.testing.assert_array_equal(work[k2 // 2], np.sort(vals, axis=0)[k2 // 2])


def test_tiny_and_single_pixel_images():
    for shape in [(1, 1), (1, 9), (7, 1), (2, 3)]:
        img = _img(shape, 4)
        np.testing.assert_array_equal(
            tfilters.median(torch.from_numpy(img), 2).numpy(),
            np.asarray(jfilters.median(img, 2)))


NET_MAX_R = kernels.MEDIAN_NETWORK_MAX_R


@pytest.mark.parametrize("r,route", [
    (1, "network"), (NET_MAX_R, "network"), (NET_MAX_R + 1, "staged"),
    # (32 + 2r)^2 u32 of tile and halo against the 232448 bytes of a block
    (104, "staged"), (105, "global"),
    # past r = 32767 the global route counts in 64 bits
    (1 << 20, "global"),
])
def test_route_switches_to_global_past_the_shared_memory(r, route):
    assert kernels.median_route(r) == route
    if route == "staged":
        assert (kernels.MEDIAN_TILE + 2 * r) ** 2 * 4 <= kernels.MAX_SMEM
    if route == "global":
        assert (kernels.MEDIAN_TILE + 2 * r) ** 2 * 4 > kernels.MAX_SMEM


def _run_network(r, taps):
    """Run the network of radius r on taps [n_inputs, ...]: its outputs."""
    n, ops, outs = median_network.network(r)
    wires = list(taps) + [None] * len(ops)
    for kind, dst, a, b in ops:
        wires[dst] = (np.minimum if kind == "min" else np.maximum)(wires[a], wires[b])
    return [wires[o] for o in outs]


def _check_network(r, grid):
    """grid: [2r + 1, NET_TW + 2r, N] taps; each output must be the median
    of its own (2r+1)^2 window."""
    k = 2 * r + 1
    got = _run_network(r, grid.reshape(-1, grid.shape[-1]))
    for t, out in enumerate(got):
        window = grid[:, t:t + k].reshape(k * k, -1)
        np.testing.assert_array_equal(out, np.sort(window, axis=0)[k * k // 2])


def test_network_selects_the_median_on_every_01_input():
    """r = 1: every 0/1 assignment of the 18 taps of the 4 windows (the
    0-1 principle: a min/max network that selects right on all 0/1 inputs
    selects right on all inputs)."""
    tw = median_network.NET_TW
    n = 3 * (tw + 2)
    bits = (np.arange(1 << n)[None, :] >> np.arange(n)[:, None]) & 1
    _check_network(1, bits.astype(np.uint8).reshape(3, tw + 2, -1))


@pytest.mark.parametrize("r", range(2, NET_MAX_R + 1))
def test_network_selects_the_median_on_random_tied_and_sorted_windows(r):
    rng = np.random.default_rng(r)
    k, cols = 2 * r + 1, median_network.NET_TW + 2 * r
    n = k * cols
    ramp = np.arange(n, dtype=np.int32)
    cases = [
        rng.integers(0, 256, (n, 100_000)),            # random u8
        rng.integers(0, 3, (n, 20_000)),               # many ties
        np.full((n, 1), 77),                           # all equal
        ramp[:, None], ramp[::-1, None],               # sorted, reversed
        ramp.reshape(k, cols).T.reshape(-1)[:, None],  # sorted by column
        ramp.reshape(k, cols).T.reshape(-1)[::-1, None],
    ]
    for taps in cases:
        _check_network(r, taps.reshape(k, cols, -1))


@pytest.mark.parametrize("r", range(1, NET_MAX_R + 1))
def test_network_shares_work_between_outputs(r):
    """Fewer min/max operations an output than the pruned Batcher network
    of one output (the Pallas kernel's)."""
    k2 = (2 * r + 1) ** 2
    comparators = [(a, b) for lo, hi in kernels._median_layers(k2) for a, b in zip(lo, hi)]
    live, batcher_ops = {k2 // 2}, 0
    for a, b in reversed(comparators):
        batcher_ops += (a in live) + (b in live)
        if a in live or b in live:
            live.update((a, b))
    _, ops, outs = median_network.network(r)
    assert len(outs) == median_network.NET_TW
    assert len(ops) / len(outs) < batcher_ops


def test_network_header_is_generated_from_the_networks():
    text = median_network.render_header(range(1, NET_MAX_R + 1))
    assert median_network.HEADER.read_text() == text


@pytest.mark.parametrize("shape", [(1, 1), (2, 7), (5, 3), (37, 53)])
@pytest.mark.parametrize("r", range(1, NET_MAX_R + 1))
def test_network_on_the_kernels_windows_matches_jax(r, shape):
    """The network fed as csrc/median.cu feeds it: each thread's NET_TW
    outputs start at a multiple of NET_TW, taps edge-replicated; the
    outputs past the right edge are dropped."""
    img = _img(shape, 30 + r)
    h, w = shape
    tw = median_network.NET_TW
    k, cols = 2 * r + 1, tw + 2 * r
    wpad = -(-w // tw) * tw
    padded = np.pad(img, ((r, r), (r, r + wpad - w), (0, 0)), mode="edge")
    grid = np.stack([padded[y:y + k, x:x + cols]
                     for y in range(h) for x in range(0, wpad, tw)], axis=-1)
    outs = _run_network(r, grid.reshape(k * cols, 4, -1))  # [4 channels, groups]
    got = np.stack(outs, axis=-1).reshape(4, h, wpad).transpose(1, 2, 0)[:, :w]
    np.testing.assert_array_equal(got, np.asarray(jfilters.median(img, r)))


def test_kernel_wrapper_refuses_bad_radius_and_counts_no_cpu_launch():
    img = torch.from_numpy(_img((8, 8), 5))
    with pytest.raises(ValueError, match="radius"):
        kernels.median_kernel(img, 0)
    before = kernels.median_kernel.launches
    kernels.median_kernel(img, 1)
    assert kernels.median_kernel.launches == before
