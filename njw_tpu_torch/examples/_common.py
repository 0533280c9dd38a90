"""What the examples share: the ``--device`` flag, a device clock, and
the line an example prints when it cannot draw."""
from __future__ import annotations

import time

import torch

from njw_tpu_torch.viz._common import have_matplotlib


def add_device(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="where the example runs: cuda (default) or "
                             "cpu (the plain PyTorch path)")


def synchronize(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a
    wall-clock read after it times the work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device):
    """(fn(), seconds), the device synchronised before the clock stops."""
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def can_draw(example: str) -> bool:
    """Whether matplotlib is there; prints the one line that says the
    example's plots were not drawn, and why, where it is not."""
    if have_matplotlib():
        return True
    print(f"{example}: plots not drawn: matplotlib is not installed",
          flush=True)
    return False
