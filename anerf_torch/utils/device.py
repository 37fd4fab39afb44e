"""Where the port runs: the GPU unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; asking for nothing on a machine without
    one raises instead of running on the CPU.  A GPU without an index
    gets the current one, so the result compares equal to a tensor's
    ``.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: pass device="cpu" to run on the CPU')
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device
