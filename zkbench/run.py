"""The benchmark of zktpu_torch: one run of one cell on the card.

    python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell's
configuration, traffic mix and per-layer metrics are found by their names in
``BENCHMARK.json``. The run makes its inputs from ``--seed``, warms up, runs the
window for ``--seconds``, checks what the window produced against the plain
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``.
The numbers the check compared, each beside its limit, are the last lines of
standard error and the line's last key.

It exits with 2, printing no result, where there is no CUDA card or fewer
than the cell asks for, and with 3 where a JAX module was loaded.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".zkbench_cache")
# kernel caches at fixed places inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
# Python's bytecode at a fixed place inside the checkout, written even where
# the environment forbids it (PYTHONDONTWRITEBYTECODE): otherwise every run
# compiles torch's sources again, some 5-7 s of its set-up
sys.pycache_prefix = os.path.join(CACHE, "pycache")
sys.dont_write_bytecode = False
# one host thread, on one core, for this process and every thread it starts
for _name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_name] = "1"
os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(1)
TORCH_IMPORTED = time.time()

from zkbench.harness import catalog, runner  # noqa: E402


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = catalog.find_cell(catalog.load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {count}")
        return 2
    log(f"import torch {TORCH_IMPORTED - STARTED:.3f} s")
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", STARTED, log)
    found = runner.forbidden_loaded(sys.modules)
    if found:
        log(f"modules that the benchmark may not load were loaded: {found}")
        return 3
    for name, check in result["checks"].items():
        log(f"{name} {check['value']} limit {check['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
