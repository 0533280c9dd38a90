from njw_tpu_torch.platform.device import (
    DeviceCaps, detect, get_device_info, require_device,
)
from njw_tpu_torch.platform.precision import float32_products
