"""The controls of ``correct``, at a cell's own size, on the card.

    python3 zkbench/controls.py --workload <cell> --seeds <n> [<n> ...]

For each seed it prints the numbers that a run's check compares, as the
control gives them: the plain reference with one guarantee of the cell's
configuration broken, in the program's place, against the reference. Each
has to read above its limit. The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from zkbench.harness import catalog  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    cell = catalog.find_cell(catalog.load_benchmark(ROOT), args.workload, ROOT)
    control = catalog.generator(cell.mix["generator"]).control
    for seed in args.seeds:
        t0 = time.time()
        numbers = control(cell.config, cell.mix, seed, torch.device(args.device))
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.time() - t0,
                          "numbers": {n: {"value": v, "limit": lim} for n, v, lim in numbers}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
