"""K5, ``ops/csrc/pe_stage.cu``: one RK4 stage of the primitive equations
per launch, four launches a step. Counting each distinct buffer a launch
reads once and the one it writes once, the four stages of a step move 2,
3, 3 and 5 states (``pe.state_bytes``): stage 1 reads s and writes s1;
stages 2 and 3 read their input and s and write; the last reads s3, s,
s1, s2 and writes the new state over s1. A one-base launch of three
distinct buffers moves 3 states (0.0761 ms at 512^2 x 20 on the data
sheet's bandwidth), the four-base one 5 (0.1268 ms)."""
from perfbench.cost import pe, peaks

KERNEL = "pe_stage_kernel"
STATES_PER_STAGE = (2, 3, 3, 5)


def launch_bound_s(config: dict, states: int, flop_per_point: int) -> float:
    n = int(config["sim"]["num_levels"]) * pe.points(config)
    return peaks.roofline_s(states * pe.state_bytes(config),
                            flop_per_point * n)


def step_bound_s(config: dict) -> float:
    """Least time of the four launches of one model step."""
    return sum(launch_bound_s(config, s, f)
               for s, f in zip(STATES_PER_STAGE, pe.FLOP_PER_STAGE))


def bound_s(config: dict, launches: int) -> float:
    """Least time of ``launches`` launches, four to a step."""
    return launches / len(STATES_PER_STAGE) * step_bound_s(config)
