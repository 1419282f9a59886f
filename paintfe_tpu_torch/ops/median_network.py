"""The selection networks of K-median's network route, and the generator of
csrc/median_network.cuh.

One thread of the network route computes NET_TW horizontally adjacent
outputs of one row at radius r.  Its inputs are the (NET_TW + 2r) x (2r + 1)
window taps they span, row-major; its outputs are the NET_TW medians.  The
program is a straight line of min and max operations on those wires,
built so that neighbouring outputs share work:

1. each of the NET_TW + 2r input columns (2r + 1 taps) is sorted once, by
   an optimal network for up to 5 values and Batcher's merge sort above;
2. the k - NET_TW + 1 columns common to every output are merged into one
   sorted list (Batcher's odd-even merge, shortest lists first); the set
   of outputs is then halved, and each half merges the columns it adds
   (merged among themselves first) into its parent's list, down to single
   outputs, whose median is element k*k // 2 of their list;
3. every operation whose result cannot reach a median is dropped, so a
   compare-exchange with one live side becomes a single min or max.

The median of integers is exact, so the network gives the JAX package's
bytes; tests/test_torch_median.py simulates it on 0/1 and random inputs.

    python -m paintfe_tpu_torch.ops.median_network   # rewrite the header
"""

from __future__ import annotations

import functools
import pathlib

NET_TW = 4  # outputs of one thread, horizontally adjacent
HEADER = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "median_network.cuh"

# optimal sorting networks for 2 to 5 values
_SMALL_SORTS = {
    2: ((0, 1),),
    3: ((0, 2), (0, 1), (1, 2)),
    4: ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)),
    5: ((0, 3), (1, 4), (0, 2), (1, 3), (0, 1), (2, 4), (1, 2), (3, 4), (2, 3)),
}


class _Builder:
    """Wires 0..n-1 are the inputs; every compare-exchange adds two wires."""

    def __init__(self, n_inputs: int):
        self.n = n_inputs
        self.ops = []  # (kind, dst, a, b), kind "min" or "max"

    def exchange(self, a: int, b: int):
        lo = self.n + len(self.ops)
        self.ops += [("min", lo, a, b), ("max", lo + 1, a, b)]
        return lo, lo + 1

    def merge(self, a: list, b: list) -> list:
        """Batcher's odd-even merge of two sorted wire lists of any length."""
        if not a or not b:
            return list(a or b)
        if len(a) == 1 and len(b) == 1:
            return list(self.exchange(a[0], b[0]))
        v = self.merge(a[0::2], b[0::2])
        w = self.merge(a[1::2], b[1::2])
        out = [v[0]]
        for j in range(max(len(w), len(v) - 1)):
            if j < len(w) and j + 1 < len(v):
                out += self.exchange(w[j], v[j + 1])
            else:
                out.append(w[j] if j < len(w) else v[j + 1])
        return out

    def sort(self, wires: list) -> list:
        wires = list(wires)
        if len(wires) in _SMALL_SORTS:
            for i, j in _SMALL_SORTS[len(wires)]:
                wires[i], wires[j] = self.exchange(wires[i], wires[j])
            return wires
        if len(wires) < 2:
            return wires
        h = len(wires) // 2
        return self.merge(self.sort(wires[:h]), self.sort(wires[h:]))

    def merge_all(self, lists: list) -> list:
        lists = [lst for lst in lists if lst]
        while len(lists) > 1:
            lists.sort(key=len)
            lists.append(self.merge(lists.pop(0), lists.pop(0)))
        return lists[0] if lists else []


@functools.lru_cache(maxsize=None)
def network(r: int):
    """The program of one thread at radius r: (n_inputs, ops, outputs).
    Inputs are numbered row-major over the (NET_TW + 2r) x (2r + 1) taps;
    ops are (kind, dst, a, b) in order, dst numbered from n_inputs up with
    no gaps; outputs are the wires of the NET_TW medians, left to right."""
    k = 2 * r + 1
    cols = NET_TW + 2 * r
    b = _Builder(cols * k)
    columns = [b.sort([y * cols + c for y in range(k)]) for c in range(cols)]
    outs = [None] * NET_TW

    def split(lo, hi, merged):
        # outputs lo..hi-1 share columns hi-1 .. lo+k-1, merged in `merged`
        if hi - lo == 1:
            outs[lo] = merged[k * k // 2]
            return
        mid = (lo + hi) // 2
        for a, z in ((lo, mid), (mid, hi)):
            extra = sorted(set(range(z - 1, a + k)) - set(range(hi - 1, lo + k)))
            split(a, z, b.merge(merged, b.merge_all([columns[c] for c in extra])))

    split(0, NET_TW, b.merge_all([columns[c] for c in range(NET_TW - 1, k)]))
    # keep only what reaches an output, then renumber the kept wires
    live, kept = set(outs), []
    for op in reversed(b.ops):
        if op[1] in live:
            kept.append(op)
            live.update(op[2:])
    kept.reverse()
    names = {w: w for w in range(b.n)}
    ops = []
    for kind, dst, x, y in kept:
        names[dst] = b.n + len(ops)
        ops.append((kind, names[dst], names[x], names[y]))
    return b.n, tuple(ops), tuple(names[o] for o in outs)


def render_header(radii) -> str:
    """csrc/median_network.cuh for the given radii."""
    lines = [
        "// Selection networks of K-median's network route, one per radius.",
        "// Generated by paintfe_tpu_torch/ops/median_network.py (see its",
        "// docstring); do not edit.  MedianNet<R>::run takes the",
        f"// ({NET_TW} + 2R) x (2R + 1) window taps of {NET_TW} horizontally adjacent",
        "// outputs, row-major, and writes their medians; Op supplies the",
        "// packed min (mn) and max (mx).",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace pfe_med {",
        "",
        f"constexpr int kNetTW = {NET_TW};",
        f"constexpr int kNetMaxR = {max(radii)};",
        "",
        "template <int R>",
        "struct MedianNet;",
    ]
    for r in radii:
        n, ops, outs = network(r)
        n_min = sum(kind == "min" for kind, *_ in ops)
        lines += [
            "",
            f"// r = {r}: {len(ops)} operations ({n_min} min, {len(ops) - n_min} max) "
            f"for {NET_TW} outputs",
            "template <>",
            f"struct MedianNet<{r}> {{",
            f"  static constexpr int kIn = {n};",
            "  template <class Op>",
            "  __device__ __forceinline__ static void run(const uint32_t* v, uint32_t* o) {",
        ]

        def name(w):
            return f"v[{w}]" if w < n else f"t{w - n}"

        for kind, dst, x, y in ops:
            fn = "mn" if kind == "min" else "mx"
            lines.append(f"    const uint32_t {name(dst)} = Op::{fn}({name(x)}, {name(y)});")
        lines += [f"    o[{i}] = {name(w)};" for i, w in enumerate(outs)]
        lines += ["  }", "};"]
    lines += ["", "}  // namespace pfe_med", ""]
    return "\n".join(lines)


def write_header():
    from paintfe_tpu_torch.ops.kernels import MEDIAN_NETWORK_MAX_R

    HEADER.write_text(render_header(range(1, MEDIAN_NETWORK_MAX_R + 1)))


if __name__ == "__main__":
    write_header()
