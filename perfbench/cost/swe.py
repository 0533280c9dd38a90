"""One RK4 step of periodic shallow water as a function: u, v, h read
once and written once (float32, 24 bytes a point), 4 * 33 + 24 operations
a point (four tendencies and the combines)."""
from perfbench.cost import peaks

BYTES_PER_POINT = 24
FLOP_PER_POINT = 4 * 33 + 24


def points(config: dict) -> int:
    """Grid points of one card's part of the domain."""
    sim = config["sim"]
    py, px = config.get("mesh", (1, 1))
    return int(sim["grid_width"]) * int(sim["grid_height"]) // (py * px)


def step_bound_s(config: dict) -> float:
    """Least time of one model step on one card's part of the domain."""
    n = points(config)
    return peaks.roofline_s(BYTES_PER_POINT * n, FLOP_PER_POINT * n)
