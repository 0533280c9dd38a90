"""Cross-process and host-device data transfer (counterpart of
``njw_tpu.interop``, without ``to_jax``: the port does not import JAX).

  shared_memory   cross-process zero-copy NumPy arrays
                  (multiprocessing.shared_memory)
  device_memory   named device buffers, transfers on a CUDA stream with
                  event handles, memory stats
  array_ops       NumPy / tensor conversions and chunked host-to-device
                  transfer through pinned memory
"""
from njw_tpu_torch.interop.shared_memory import SharedArray, SharedMemoryManager
from njw_tpu_torch.interop.device_memory import DeviceMemoryManager
from njw_tpu_torch.interop.array_ops import (
    to_numpy, to_torch, chunked_device_put, zero_copy_view,
)
