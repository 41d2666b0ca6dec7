"""Device policy of the port: entry points run on the card unless the
caller asks for the CPU, and asking for the card where there is none is an
error, never a silent fall back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev
