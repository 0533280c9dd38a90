"""Readings behind the bf16 kernel's gate (K1-bf16 against its plain version).

For each case of chip_smoke.py's phase 12 and of the bf16 case in
tests/test_torch_cuda.py, one JSON line: the bf16 kernel's largest
distance from its plain version over max|h|, the float32 kernel's (the
control), and the RMS distance of each (the largest over u, v, h) with
their ratio, the quantity chip_smoke.py gates. Run it on a copy of the
checkout with one edit to the kernel to read a mutant.

    python scripts/bf16_gate_readings.py [--tag NAME]

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="checkout")
    args = ap.parse_args()

    import torch
    from njw_tpu_torch.ops import stencil
    from njw_tpu_torch.weather import GridSpec, make_initial_state
    from njw_tpu_torch.weather.main_paths import MAIN_PATHS
    from test_torch_cuda import _fields, _torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    swe = MAIN_PATHS["swe"]
    n = swe.config["grid_width"]

    def ic(ny, nx, name, kw):
        s = make_initial_state(name, GridSpec(nx=nx, ny=ny), device="cuda",
                               **kw)
        return s.u, s.v, s.h

    cases = []  # name, ny, nx, fields, dt, viscosity
    for nu in (0.0, 0.02):
        cases += [
            ("smoke_main_2048", n, n,
             lambda: ic(n, n, swe.ic, swe.ic_params), swe.config["dt"], nu),
            ("smoke_ragged_1000x1500", 1000, 1500,
             lambda: ic(1000, 1500, "breaking_wave", {"amplitude": 0.3}),
             0.005, nu),
            ("smoke_tiny_5x7", 5, 7,
             lambda: ic(5, 7, "random", {"amplitude": 0.1, "seed": 2}),
             0.001, nu)]
    for ny, nx, nu in [(256, 256, 0.0), (200, 328, 0.02), (5, 7, 0.0),
                       (33, 65, 0.01)]:
        cases.append((f"test_{ny}x{nx}", ny, nx,
                      lambda ny=ny, nx=nx: _torch(
                          _fields(ny, nx, seed=nx + 1), "cuda"), 0.01, nu))

    def rms(a, b):
        return max(float((x.double() - y.double()).pow(2).mean().sqrt())
                   for x, y in zip(a, b))

    def largest(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    for name, ny, nx, make, dt, nu in cases:
        f = make()
        kw = dict(grid=GridSpec(nx=nx, ny=ny), dt=dt, coriolis_f=1e-4,
                  viscosity=nu)
        kern = stencil.swe_rk4_step_cuda(*f, variant="bf16", **kw)
        plain = stencil.swe_rk4_step_plain(*f, variant="bf16", **kw)
        f32 = stencil.swe_rk4_step_cuda(*f, **kw)
        torch.cuda.synchronize()
        scale = float(plain[2].abs().max())
        control = rms(f32, plain)
        print(json.dumps({
            "tag": args.tag, "case": name, "viscosity": nu,
            "err_rel_to_max_h": largest(kern, plain) / scale,
            "control_rel_to_max_h": largest(f32, plain) / scale,
            "rms_err": rms(kern, plain), "rms_control": control,
            "rms_share": rms(kern, plain) / control if control else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
