"""Device selection shared by the port's entry points.

Entry points (``init_params``, ``AdapterRegistry``, ``ServeEngine``) run on
the GPU unless the caller asks for the CPU: ``device=None`` means
``"cuda"``, and a missing CUDA device is an error, never a silent move to
the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:      # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
