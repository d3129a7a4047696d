from nngp_tpu_torch.native.fastenc import (
    FastEncoder,
    is_available,
)

__all__ = ["FastEncoder", "is_available"]
