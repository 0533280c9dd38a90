"""One block of a periodic reference forecast, computed over its
dependence cone, so that a card holds the reference of its own part of a
domain too large to hold whole beside the program.

A block's value after n RK4 steps depends on the block and
``rk4.HALO_PER_STEP * n`` cells around it (periodic wrap). The initial
condition is made whole (the reference's own, with its host draw), the
block's cone is cut from it, and each step of ``rk4.rk4_step`` on it
gives the cone four cells smaller on each side, without padding: the
block's values are those of the whole-domain forecast, computed by the
same operations on the same points.
"""
from __future__ import annotations

from perfbench.reference import rk4


def block_snapshots(ref, sim: dict, ic: str, params: dict, steps: int,
                    interval: int, block: tuple, device):
    """Yield (step, fields of ``block``) at every ``interval`` steps up to
    ``steps`` of the reference module ``ref`` (``pe``), in float32;
    ``block`` = (y0, y1, x0, x1), ends excluded."""
    ref.check_config(sim)
    ny, nx, L = (int(sim["grid_height"]), int(sim["grid_width"]),
                 int(sim["num_levels"]))
    whole = ref.INITIAL_CONDITIONS[ic](ny, nx, L, device, **params)
    y0, y1, x0, x1 = block
    s = rk4.periodic_region(whole, y0, y1, x0, x1,
                            rk4.HALO_PER_STEP * steps)
    del whole
    tendency = ref.tendency_fn(sim, L, device, s["u"].dtype)
    dt = float(sim["dt"])
    done = 0
    while done < steps:
        for _ in range(min(interval, steps - done)):
            s = rk4.rk4_step(s, tendency, dt)
            done += 1
        left = rk4.HALO_PER_STEP * (steps - done)
        yield done, {k: rk4.crop(a, left) for k, a in s.items()}
