"""The benchmark of physher_tpu_torch on one NVIDIA H100: one run of one
cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as one JSON line on standard output, and each number
the check compared, beside its limit, as the last lines of standard
error. Exits non-zero without a CUDA device (no fallback to the CPU), and
if the process holds jax, jaxlib, flax or the JAX package once its window
has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process with few threads: the host paces most of these steps, and
# idle pool threads spinning beside the main one make its pace uneven
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    import torch

    from portbench import harness, manifest

    torch.set_num_threads(1)

    cell = manifest.cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the process holds {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
