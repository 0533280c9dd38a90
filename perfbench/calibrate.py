#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's
own size (the benchmark's runs do not run this):

    python3 perfbench/calibrate.py --workload pe512x20.forecast \
        --seeds 11 12 13 --control-seeds 11 12 13

For each seed of ``--seeds`` it draws the window's first forecast from
that seed, runs it through the timed path (``drivers/simulation.py``'s
forecast: ``Simulation.from_config`` and ``Simulation.run``) and prints
the cell's numbers against the reference: the lower readings. For each
of ``--control-seeds`` it puts the control in the program's place, the
reference computed in the precision below the configuration's (bfloat16
for float32; ``--controls`` chooses how much of it, see
``control_snapshots``), and prints its numbers: the upper readings. One
JSON line a reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOWER_PRECISION = {"float32": "bfloat16", "float64": "float32"}
CONTROLS = ("full", "storage", "output", "derived")


def _lower(c, control: str):
    """(the precision below the configuration's, the reference's keyword
    arguments for ``control``)."""
    import torch

    low = getattr(torch, LOWER_PRECISION[c.config["precision"]])
    return low, {"full": {"dtype": low}, "storage": {"storage": low},
                 "output": {}, "derived": {}}[control]


def control_snapshots(c, params: dict, device, control: str = "full"
                      ) -> list:
    """The control's snapshots, as the program's (host arrays by name,
    with their step): the reference in the precision below the
    configuration's, ``full``: every operation in it; ``storage``: the
    state rounded to it after every step, the arithmetic in the
    configuration's; ``output``: the configuration's precision
    throughout, each snapshot rounded to it; ``derived``: the same, with
    only the fields derived from the state (the diagnostics) rounded."""
    from perfbench import harness

    ref, t = harness.reference(c), c.traffic
    low, kw = _lower(c, control)
    out = []
    for step, fields in ref.snapshots(c.config["sim"], t["ic"], params,
                                      t["steps"], t["output_interval"],
                                      device, **kw):
        if control == "output":
            fields = {k: v.to(low) for k, v in fields.items()}
        elif control == "derived":
            fields = {k: v if k in ref.FIELDS else v.to(low)
                      for k, v in fields.items()}
        snap = {k: v.float().cpu().numpy() for k, v in fields.items()}
        snap["step"] = step
        out.append(snap)
    return out


def control_readings(c, params: dict, device, control: str) -> dict:
    """{number: reading} of the control."""
    from perfbench import harness

    snaps = control_snapshots(c, params, device, control)
    got = harness.check(c, [(params, snaps)], device)
    return {k: v["value"] for k, v in got.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", nargs="*", default=["full"],
                   choices=CONTROLS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from njw_tpu_torch.weather.model import SimConfig, Simulation
    from perfbench import harness
    from perfbench.drivers.simulation import _forecast
    from perfbench.trace import Spans

    c = harness.cell(args.workload)
    dev = torch.device(args.device)
    cfg = SimConfig(**c.config["sim"], device=args.device)
    for seed in args.seeds:
        params = harness.Draws(c.traffic, seed)()
        t0 = time.perf_counter()
        snaps, _, _, _, _ = _forecast(
            Simulation, cfg, c.traffic, params, Spans(), c.config["fields"],
            lambda: torch.cuda.synchronize(dev) if dev.type == "cuda"
            else None, [])
        secs = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = harness.check(c, [(params, snaps)], dev)
        print(json.dumps({"reading": "program", "seed": seed,
                          "params": params, "forecast_s": secs,
                          "reference_s": time.perf_counter() - t0,
                          **{k: v["value"] for k, v in got.items()}}),
              flush=True)
    for seed in args.control_seeds:
        params = harness.Draws(c.traffic, seed)()
        for control in args.controls:
            got = control_readings(c, params, dev, control)
            print(json.dumps({"reading": f"control.{control}", "seed": seed,
                              "params": params, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
