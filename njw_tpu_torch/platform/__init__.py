from njw_tpu_torch.platform.device import (
    DeviceCaps, default_mesh, detect, get_device_info, hbm_bandwidth_gbps,
    is_tpu_available, mesh_shape, require_device, stencil_block_shape,
    tpu_generation,
)
from njw_tpu_torch.platform.precision import float32_products
