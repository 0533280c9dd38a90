#!/usr/bin/env python3
"""Run one cell of the benchmark of the port, ``njw_tpu_torch``, on the
cards of this machine, and print its result as the last line of standard
output:

    python3 perfbench/run.py --workload swe2048.forecast --seed 7 \
        --seconds 30 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a device trace of the window. The cells, and
the files each is made of, are named in ``BENCHMARK.json``
(``perfbench/harness.py``). Without as many CUDA cards as the cell asks
for, it prints no result and exits with 2.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    c = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {c.chips} CUDA card(s), "
              f"this machine has {have}; no result", file=sys.stderr)
        return 2
    import njw_tpu_torch

    if Path(njw_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print(f"perfbench: njw_tpu_torch comes from {njw_tpu_torch.__file__}"
              f", not from this checkout; no result", file=sys.stderr)
        return 2
    record = harness.driver(c).run(c, args.seed, args.seconds,
                                   bool(args.trace), START)
    return harness.emit(record, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
