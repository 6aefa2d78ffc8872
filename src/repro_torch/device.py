"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the card. A CPU
run happens only when the caller asks for ``device="cpu"``; a request for
the card on a host without one raises instead of falling back.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available "
            "(pass device='cpu' for a CPU run)")
    return dev


H100_SMS = 132  # what a meta-device plan assumes


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, for a kernel's launch shape (`H100_SMS`
    on the meta device, where the dry run plans for an H100 SXM)."""
    if device.type == "meta":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def host_to_device(array, device) -> torch.Tensor:
    """A host array (frames, labels) as one tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)
