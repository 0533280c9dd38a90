"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions.

Each kernel's wrapper adds one to its launch counter where it launches
the kernel, and nowhere else; ``launch_counters`` names them all.
"""


def launch_counters() -> dict:
    """{kernel: (the wrapper that carries its launch count, the count's
    attribute)} for every hand-written kernel of the port."""
    from njw_tpu_torch.ops import baro_stencil, pe_stencil, stencil
    from njw_tpu_torch.signal import fir_cuda

    return {"swe_rk4": (stencil.swe_rk4_step_cuda, "launches"),
            "swe_rk4_bf16": (stencil.swe_rk4_step_cuda, "bf16_launches"),
            "swe_rk4_multi": (stencil.swe_rk4_multistep_cuda, "launches"),
            "baro_stage": (baro_stencil.baro_stage_cuda, "launches"),
            "pe_stage": (pe_stencil.pe_stage_cuda, "launches"),
            "pe_rk4": (pe_stencil.pe_rk4_step_cuda, "launches"),
            "fir_band": (fir_cuda.fir_band_cuda, "launches"),
            "fir_band_bf16": (fir_cuda.fir_band_bf16_cuda, "launches")}


def launch_counts() -> dict:
    """{kernel: launches counted so far}."""
    return {name: getattr(w, attr)
            for name, (w, attr) in launch_counters().items()}
