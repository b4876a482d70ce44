"""Device selection for the port's entry points."""
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card; with no card present that raises instead of
    carrying on quietly on the CPU. The CPU is used only when asked for by
    name (``device="cpu"``), as the CPU tests do.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        # name the card, so that devices compare equal however they were asked for
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        device = torch.device("cuda", torch.cuda.current_device())
    return device
