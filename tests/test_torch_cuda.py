"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA device (the kernels have no CPU mode): they carry
the ``cuda`` marker and skip without one. They import torch and the port
only, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from njw_tpu_torch.ops.stencil import (  # noqa: E402
    swe_rk4_step, swe_rk4_step_cuda, swe_rk4_step_plain,
)
from njw_tpu_torch.weather import GridSpec, SimConfig, Simulation  # noqa: E402


def _fields(ny, nx, seed=0, amp=0.5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-amp, amp, (ny, nx)).astype(np.float32),
            rng.uniform(-amp, amp, (ny, nx)).astype(np.float32),
            (10.0 + rng.uniform(-amp, amp, (ny, nx))).astype(np.float32))


def _torch(fields, device):
    return tuple(torch.from_numpy(f.copy()).to(device) for f in fields)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("ny,nx,nu", [(256, 256, 0.0), (200, 328, 0.02),
                                          (3, 5, 0.0), (33, 65, 0.0)])
    def test_kernel_matches_plain_version(self, cuda_device, ny, nx, nu):
        grid = GridSpec(nx=nx, ny=ny)
        f = _torch(_fields(ny, nx, seed=nx), cuda_device)
        kw = dict(grid=grid, dt=0.01, coriolis_f=1e-4, viscosity=nu)
        before = swe_rk4_step_cuda.launches
        out = swe_rk4_step(*f, **kw)
        ref = swe_rk4_step_plain(*f, **kw)
        torch.cuda.synchronize()
        assert swe_rk4_step_cuda.launches == before + 1
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

    def test_simulation_kernel_vs_plain(self, cuda_device):
        cfg = SimConfig(grid_width=128, grid_height=96, dt=0.01,
                        coriolis_f=1e-4, device="cuda")
        ker = Simulation.from_config(cfg, "vortex", strength=2.0)
        ref = Simulation.from_config(SimConfig(
            grid_width=128, grid_height=96, dt=0.01, coriolis_f=1e-4,
            device="cuda", backend="plain"), "vortex", strength=2.0)
        assert ker.stepper.name == "rk4_kernel" and ref.stepper.name == "rk4"
        ker.step(12)
        ref.step(12)
        torch.testing.assert_close(ker.state.h, ref.state.h, rtol=1e-3,
                                   atol=1e-3)
