"""K1, ``ops/csrc/swe_rk4.cu``: one whole RK4 step of periodic shallow
water per launch. A launch reads u, v, h once and writes them once
(float32): 24 bytes a point, 0.0300 ms at 2048^2 on the data sheet's
bandwidth. Its operations, four tendencies and the combines (4 * 33 + 24
a point), take less than half that at 67 TFLOP/s."""
from perfbench.cost import swe

KERNEL = "swe_rk4_kernel"     # the kernel's name in the device trace


def launch_bound_s(config: dict) -> float:
    """Least time of one launch, which is one model step."""
    return swe.step_bound_s(config)


def bound_s(config: dict, launches: int) -> float:
    """Least time of ``launches`` launches."""
    return launches * launch_bound_s(config)

