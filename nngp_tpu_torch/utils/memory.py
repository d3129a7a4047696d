"""Host / device memory probes: the counterpart of
`nngp_tpu/utils/memory.py` (`reference/util.py:17-24` used pynvml and
psutil). Host RSS when psutil is installed; on a CUDA device, the memory
its tensors hold (`torch.cuda.memory_allocated`), under the JAX package's
`<device kind>:<id>_gb` keys.
"""

import torch


def memory_usage_gb(device) -> dict:
    """Host RSS, and the memory tensors hold on `device` when it is a CUDA
    device."""
    out = {}
    try:
        import psutil
        out["host_rss_gb"] = psutil.Process().memory_info().rss / 1024 ** 3
    except ImportError:
        pass
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        out[f"{name}:{device.index or 0}_gb"] = (
            torch.cuda.memory_allocated(device) / 1024 ** 3)
    return out
