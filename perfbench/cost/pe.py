"""One RK4 step of the primitive equations as a function: the state, 4 L
+ 1 float32 planes (u, v, T, q over L levels, and ps), read once and
written once; 3 * 116 + 140 operations a column-level (three one-base
stages and the four-base one)."""
from perfbench.cost import peaks

FLOP_PER_STAGE = (116, 116, 116, 140)


def points(config: dict) -> int:
    """Horizontal points of one card's part of the domain."""
    sim = config["sim"]
    py, px = config.get("mesh", (1, 1))
    return int(sim["grid_width"]) * int(sim["grid_height"]) // (py * px)


def state_bytes(config: dict) -> int:
    return (4 * int(config["sim"]["num_levels"]) + 1) * points(config) * 4


def step_flop(config: dict) -> int:
    return sum(FLOP_PER_STAGE) * int(config["sim"]["num_levels"]) \
        * points(config)


def step_bound_s(config: dict) -> float:
    """Least time of one model step on one card's part of the domain."""
    return peaks.roofline_s(2 * state_bytes(config), step_flop(config))
