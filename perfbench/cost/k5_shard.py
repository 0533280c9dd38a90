"""K5, ``ops/csrc/pe_stage.cu``, in its padded form on one card's block of
a mesh (``pe_stage_local2d``): one RK4 stage a launch, four a step, the
input state read as its (L, ly + 2, lx + 2) padded block and the bases
and output at the (L, ly, lx) interior. ``k5.py``'s rule, each distinct
buffer a launch reads counted once and the one it writes once: stage 1
reads the padded s (its interior is the base) and writes s1; stages 2
and 3 read their padded input and the base s and write; the last reads
the padded s3 (its interior is a base) and s, s1, s2, and writes the new
state over s1. So a step moves four padded states and 1 + 2 + 2 + 4
interior ones."""
from perfbench.cost import k5, pe, peaks

KERNEL = k5.KERNEL
PADDED_PER_STAGE = (1, 1, 1, 1)
INTERIOR_PER_STAGE = (1, 2, 2, 4)


def block(config: dict) -> tuple:
    """(L, ly, lx) of one card's block."""
    sim = config["sim"]
    py, px = config["mesh"]
    return (int(sim["num_levels"]), int(sim["grid_height"]) // py,
            int(sim["grid_width"]) // px)


def padded_bytes(config: dict) -> int:
    L, ly, lx = block(config)
    return (4 * L + 1) * (ly + 2) * (lx + 2) * 4


def launch_bound_s(config: dict, stage: int) -> float:
    """Least time of the launch of ``stage`` (0 to 3)."""
    L, ly, lx = block(config)
    n_bytes = (PADDED_PER_STAGE[stage] * padded_bytes(config)
               + INTERIOR_PER_STAGE[stage] * pe.state_bytes(config))
    return peaks.roofline_s(n_bytes, pe.FLOP_PER_STAGE[stage] * L * ly * lx)


def step_bound_s(config: dict) -> float:
    return sum(launch_bound_s(config, i) for i in range(4))


def bound_s(config: dict, launches: int) -> float:
    """Least time of ``launches`` launches, four to a step."""
    return launches / 4 * step_bound_s(config)
