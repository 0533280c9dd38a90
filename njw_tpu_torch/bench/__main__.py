"""CLI: python -m njw_tpu_torch.bench (the flags of ``python -m
njw_tpu.bench``, plus ``--device``: cuda unless given)."""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="njw_tpu_torch.bench")
    p.add_argument("--all", action="store_true", help="run every workload")
    p.add_argument("--workloads", nargs="*", default=None)
    p.add_argument("--params", default="{}",
                   help='JSON per-workload params, e.g. '
                        '\'{"weather": {"grid_size": 1024}}\'')
    p.add_argument("--cost", default=None,
                   choices=["on_prem_tpu", "cloud_tpu", "cloud_gpu",
                            "slurm_cluster", "local_cpu"])
    p.add_argument("--cost-config", default=None, metavar="YAML",
                   help="cost-model config file (see configs/*.yaml); "
                        "overrides --cost")
    p.add_argument("--output-dir", default="./benchmark_results")
    p.add_argument("--report", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from njw_tpu_torch.bench import (
        BenchmarkSuite, CostModelFactory, load_cost_model,
    )

    suite = BenchmarkSuite(output_dir=args.output_dir, device=args.device)
    names = (list(suite.registry) if args.all
             else (args.workloads or ["weather"]))
    if args.cost_config:
        cost_model = load_cost_model(args.cost_config)
    else:
        cost_model = (CostModelFactory.create(args.cost)
                      if args.cost else None)
    params = json.loads(args.params)

    for name in names:
        r = suite.run_benchmark(name, cost_model, **params.get(name, {}))
        print(json.dumps(r.to_dict()), flush=True)

    path = suite.save_results()
    print(f"results: {path}", file=sys.stderr)
    if args.report:
        html = suite.generate_reports()
        print(f"report:  {html}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
