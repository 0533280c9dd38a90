"""Faults planted in the ranks of a mesh run for the tests of ``correct``
and of a run that must end (``drivers/process_mesh.py`` calls one in each
rank with the rank's number)."""
from perfbench.tests import faults


def shifted_halo_column(rank: int) -> None:
    """Rank 1 receives every halo column shifted by one row."""
    if rank != 1:
        return
    import torch

    from njw_tpu_torch.parallel import mesh

    make = mesh.ProcessMesh.pair_exchange

    def shifted(self, to_next, to_prev, axis):
        exchange = make(self, to_next, to_prev, axis)
        if axis != "x":
            return exchange

        def rolled():
            return tuple([tuple(torch.roll(t, 1, dims=-2) for t in p)
                          for p in side] for side in exchange())

        return rolled

    mesh.ProcessMesh.pair_exchange = shifted


def altered_snapshot(rank: int) -> None:
    """Rank 3's snapshot of T is altered at one point as it is stored."""
    if rank == 3:
        faults.altered_answer("T")


def raises_in_the_window(rank: int) -> None:
    """Rank 2 raises at its first forecast after the warm-up; the others
    are left waiting in an exchange."""
    if rank != 2:
        return
    from njw_tpu_torch.weather.model import Simulation

    run, calls = Simulation.run, []

    def failing(self, *args, **kwargs):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("a fault planted in rank 2")
        return run(self, *args, **kwargs)

    Simulation.run = failing
