"""The platform layer: device detection, roofline constants, meshes.

Counterpart of ``njw_tpu/platform/device.py``. What the CUDA runtime
reports (name, compute capability, SM count, opt-in shared memory per
block, L2 size, memory size) comes from ``torch.cuda.get_device_properties``;
what it does not report (memory bandwidth, fp32 and bf16 tensor-core
peaks) comes from a small spec table keyed by the device name.

The JAX module's TPU names: ``is_tpu_available`` and ``DeviceCaps.is_tpu``
answer False on every device of the port; ``hbm_bandwidth_gbps`` gives
the card's memory rate; ``default_mesh`` factors the devices (or ranks)
as the JAX one does. ``tpu_generation`` and ``stencil_block_shape`` raise
``NotImplementedError``: a GPU has no TPU generation (``detect().name``
and ``.generation``, the compute capability, describe it), and the
port's kernels size their tiles by their own rules, not by a VMEM budget.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

# Published per-card figures (NVIDIA H100 Tensor Core GPU datasheet, SXM /
# PCIe / NVL columns; NVIDIA H200 datasheet): memory bandwidth in GB/s,
# dense fp32 (non-tensor-core) peak and dense bf16 tensor-core peak in
# TFLOP/s (the data sheets' bf16 figures are with sparsity, twice these).
# Matched by substring of ``torch.cuda.get_device_name``, most specific
# first.
_SPEC_TABLE = (
    # substring     bw_gbps  fp32_tflops  bf16_tc_tflops
    ("H100 PCIe", 2000.0, 51.0, 756.0),
    ("H100 NVL", 3900.0, 60.0, 835.0),
    ("H200", 4800.0, 67.0, 989.0),
    ("H100", 3350.0, 67.0, 989.0),  # SXM5 ("NVIDIA H100 80GB HBM3")
)


@dataclasses.dataclass(frozen=True)
class DeviceCaps:
    """What the port needs to know about its device."""

    platform: str                 # 'cuda' | 'cpu'
    name: str
    num_devices: int
    generation: str = "cpu"       # compute capability, 'sm_90' on an H100
    sm_count: int = 0
    smem_per_block_optin: int = 0  # bytes of dynamic shared memory a block may opt into
    l2_bytes: int = 0
    total_memory_bytes: int = 0
    hbm_bandwidth_gbps: Optional[float] = None  # None: not in the spec table
    peak_fp32_tflops: Optional[float] = None
    peak_bf16_tensor_tflops: Optional[float] = None

    @property
    def is_cuda(self) -> bool:
        return self.platform == "cuda"

    @property
    def is_tpu(self) -> bool:
        """False: the port runs on CUDA devices and the CPU."""
        return False


def spec_for(name: str) -> tuple[Optional[float], Optional[float],
                                 Optional[float]]:
    """(memory GB/s, fp32 TFLOP/s, bf16 tensor-core TFLOP/s) for a device
    name, or Nones."""
    for key, *spec in _SPEC_TABLE:
        if key in name:
            return tuple(spec)
    return None, None, None


def detect(device: str | torch.device = "cuda") -> DeviceCaps:
    """Describe ``device`` (CUDA index 0 by default, or the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_device(dev)
        props = torch.cuda.get_device_properties(dev.index or 0)
        bw, fp32, bf16_tc = spec_for(props.name)
        return DeviceCaps(
            platform="cuda", name=props.name,
            num_devices=torch.cuda.device_count(),
            generation=f"sm_{props.major}{props.minor}",
            sm_count=props.multi_processor_count,
            smem_per_block_optin=getattr(props, "shared_memory_per_block_optin", 0),
            l2_bytes=getattr(props, "L2_cache_size", 0),
            total_memory_bytes=props.total_memory,
            hbm_bandwidth_gbps=bw, peak_fp32_tflops=fp32,
            peak_bf16_tensor_tflops=bf16_tc,
        )
    if dev.type == "cpu":
        return DeviceCaps(platform="cpu", name="cpu", num_devices=1)
    raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")


def require_device(device: str | torch.device) -> torch.device:
    """Return ``device`` as a torch.device; raise when it is CUDA and no
    CUDA device is present (entry points never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: njw_tpu_torch runs on the GPU by "
            "default; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")
    return dev


def get_device_info(device: str | torch.device = "cuda") -> dict:
    """Counterpart of ``njw_tpu.platform.get_device_info``: every key of
    the JAX function, with this device's values, beside the port's own
    (the fields of ``DeviceCaps``).

    ``hbm_gb`` is the device memory in GB of 2**30 bytes (the unit of the
    JAX table's per-chip figures and of the card's nameplate; 0.0 on the
    CPU, as in JAX) and ``peak_bf16_tflops`` the dense bf16 tensor-core
    peak. ``vmem_bytes`` and ``ici_bandwidth_gbps`` are None: a GPU has
    no VMEM (a TPU core's vector memory; shared memory is
    ``smem_per_block_optin``) and no ICI (the TPU inter-chip links).
    """
    caps = detect(device)
    return {**dataclasses.asdict(caps),
            "hbm_gb": caps.total_memory_bytes / 2 ** 30,
            "peak_bf16_tflops": caps.peak_bf16_tensor_tflops,
            "vmem_bytes": None, "ici_bandwidth_gbps": None}


def hbm_bandwidth_gbps(device: str | torch.device = "cuda") -> Optional[float]:
    """The device's memory rate in GB/s (None where the spec table has no
    figure: the CPU, or a card not in it)."""
    return detect(device).hbm_bandwidth_gbps


def is_tpu_available() -> bool:
    """False: the port has no TPU path (``torch.cuda.is_available`` says
    whether its device is there)."""
    return False


def tpu_generation() -> str:
    """No counterpart: raises NotImplementedError."""
    raise NotImplementedError(
        "tpu_generation: the port runs on CUDA devices, which have no TPU "
        "generation; detect().name and detect().generation (the compute "
        "capability) describe the card")


def stencil_block_shape(ny: int, nx: int, n_fields: int = 3,
                        dtype_bytes: int = 4, caps=None):
    """No counterpart: raises NotImplementedError."""
    raise NotImplementedError(
        "stencil_block_shape picks a Pallas VMEM block on a TPU; the port's "
        "CUDA kernels size their tiles by their own rules "
        "(ops.stencil.swe_layout, ops.pe_stencil.stage_tile_rows, "
        "ops.baro_stencil.baro_strip, signal.fir_cuda.fir_layout)")


def mesh_shape(n: int) -> tuple[int, int]:
    """n devices factored as near square as possible, the larger factor
    first (8 -> (4, 2)): the JAX ``default_mesh`` rule."""
    a = int(math.sqrt(n))
    while n % a:
        a -= 1
    return (n // a, a)


def default_mesh(shape: Optional[tuple[int, int]] = None, *,
                 device: str | torch.device = "cuda"):
    """A (py, px) mesh of shards for spatial domain decomposition.

    With a ``torch.distributed`` process group up, a ``ProcessMesh`` over
    its ranks (one shard a rank, on ``device``); otherwise a ``LocalMesh``
    holding every shard on ``device``. Without ``shape``, the ranks (or
    the CUDA devices; 1 on the CPU) are factored as near square as
    possible (``mesh_shape``). The port's meshes cut rows over 'y' and
    columns over 'x' (``parallel.mesh``)."""
    import torch.distributed as dist

    from njw_tpu_torch.parallel.mesh import LocalMesh, ProcessMesh

    dev = require_device(device)
    distributed = dist.is_available() and dist.is_initialized()
    if shape is None:
        shape = mesh_shape(dist.get_world_size() if distributed
                           else torch.cuda.device_count()
                           if dev.type == "cuda" else 1)
    if distributed:
        return ProcessMesh(*shape, device=dev)
    return LocalMesh(*shape, device=dev)
