"""The platform layer: device detection and roofline constants.

Counterpart of ``njw_tpu/platform/device.py`` (``DeviceCaps``, ``detect``,
``get_device_info``). What the CUDA runtime reports (name, SM count,
opt-in shared memory per block, L2 size, memory size) comes from
``torch.cuda.get_device_properties``; what it does not report (memory
bandwidth, fp32 and bf16 tensor-core peaks) comes from a small spec table
keyed by the device name.
"""
from __future__ import annotations

import dataclasses
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
    """Counterpart of ``njw_tpu.platform.get_device_info``."""
    return dataclasses.asdict(detect(device))
