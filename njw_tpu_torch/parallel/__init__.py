"""Sharded weather paths (counterpart of ``njw_tpu.parallel``).

  mesh.py   LocalMesh (every shard in one process) and ProcessMesh (one
            shard per torch.distributed rank): ring_shift (and its
            non-blocking start), all_to_all, all_reduce_sum,
            shard_state, gather_state,
            and the mesh's own counts of its exchanges
  halo.py   halo_pad_2d; the plain sharded steppers (SWE and PE on every
            BC and integrator, with the exchange overlapped with the
            interior, and the barotropic core, 1-D and 2-D); and the
            kernel-backed sharded steppers (SWE on K1, PE on the
            whole-step kernel K4 or the stage kernel K5, 1-D and 2-D, with
            the persistent carry forms)
  fft.py    the distributed transpose-FFT and pencil-FFT Poisson solves
  sphere.py the latitude-sharded spectral cores (all_reduce_sum of the
            quadrature partials)
  icosa.py  the panel-pair sharded icosahedral SWE (two ring exchanges
            a halo)

Every path of the JAX package's ``parallel`` is ported.
"""
from njw_tpu_torch.parallel.mesh import LocalMesh, ProcessMesh
from njw_tpu_torch.parallel.halo import (
    PlainShardedStepper, ShardedStepper, halo_pad_2d, interior_crop,
    make_padded_shift_fn, sharded_barotropic_step,
    sharded_barotropic_step_2d, sharded_pe_step, sharded_pe_step_kernel,
    sharded_pe_step_kernel_2d, sharded_pe_step_kernel_fused,
    sharded_pe_step_kernel_fused_2d, sharded_swe_step,
    sharded_swe_step_kernel, sharded_swe_step_kernel_2d,
)
from njw_tpu_torch.parallel.sphere import (
    replicate, shard_sht, sharded_spherical_step,
)
from njw_tpu_torch.parallel.icosa import (
    pad_halo_pairs, shard_icosa, sharded_icosa_swe_step, unshard_state,
)
