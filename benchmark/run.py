"""Run one benchmark cell of leastereo_tpu_torch once and print its result.

    python3 benchmark/run.py --workload kitti15_stream --seed 1 --seconds 20 --trace 0

From the root of a checkout, on a machine with the CUDA devices the cell
asks for (``BENCHMARK.json``); without them it prints no result and exits
2. The last line of standard output is the result (JSON); the numbers the
check compared, each beside its limit, are the last lines of standard
error and the result's last key. Builds and caches stay inside the
checkout: the program's kernels in ``leastereo_tpu_torch/build/``, other
compiler caches under ``build/benchmark/``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache = ROOT / "build" / "benchmark"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):  # one process, few threads: steadier host timing
        os.environ[var] = "1"
    sys.path[0] = str(ROOT)  # the checkout, not this folder, whose module names would shadow others
    from benchmark.harness import run

    return run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
