"""Device policy of the port: entry points run on the card unless the
caller asks for the CPU, and asking for the card where there is none is an
error, never a silent fall back to the CPU. ``visible_devices`` lists the
devices an engine may spread a plan over."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev


def visible_devices(device: torch.device):
    """Every visible device of `device`'s type (the cards, in index
    order; the one CPU), or [device] where `device` names an index."""
    if device.index is not None or device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
