"""Sharded weather paths (counterpart of ``njw_tpu.parallel``).

  mesh.py   LocalMesh (every shard in one process) and ProcessMesh (one
            shard per torch.distributed rank): ring_shift, shard_state,
            gather_state
  halo.py   halo_pad_2d and the kernel-backed sharded steppers (SWE on K1,
            PE on the whole-step kernel K4 or the stage kernel K5, 1-D and
            2-D, with the persistent carry forms)

The plain sharded steppers, the sharded barotropic core with
``parallel/fft.py``, ``parallel/sphere.py`` and ``parallel/icosa.py`` are
not yet ported (ROADMAP).
"""
from njw_tpu_torch.parallel.mesh import LocalMesh, ProcessMesh
from njw_tpu_torch.parallel.halo import (
    ShardedStepper, halo_pad_2d, interior_crop, make_padded_shift_fn,
    sharded_pe_step_kernel, sharded_pe_step_kernel_2d,
    sharded_pe_step_kernel_fused, sharded_pe_step_kernel_fused_2d,
    sharded_swe_step_kernel, sharded_swe_step_kernel_2d,
)
