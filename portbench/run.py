"""Run one cell of BENCHMARK.json once, on the cards of this machine:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each number compared with the plain reference beside its
limit (also the last lines of standard error).  Exits 1 without a result
when the machine has no card or fewer than the cell asks for, or when a
module of JAX or of the JAX package was loaded; exits 1 after the result
when a per-layer metric of the cell found nothing to read in its trace.
`--control 1` puts the reference, computed in bfloat16, in the program's
place: a check of the comparison, which has to come out not correct.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench.harness import BENCH  # noqa: E402

CACHE = BENCH / ".cache"


def set_caches():
    """Fixed cache directories inside the checkout, so that only the first
    run of a checkout builds (the program's kernel library builds into its
    own paintfe_tpu_torch/build/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()

    import torch

    from portbench import harness

    spec, _, _ = harness.resolve(harness.benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card on this machine", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < spec["chips"]:
        print(f"portbench: {args.workload} needs {spec['chips']} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    devices = [torch.device("cuda", i) for i in range(spec["chips"])]
    try:
        result = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                                 devices, t0=T0, control=bool(args.control))
    except harness.ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    for k, c in result["checks"].items():
        print(f"portbench check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    if result.get("missing"):
        print(f"portbench: no device events for {', '.join(result['missing'])}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
