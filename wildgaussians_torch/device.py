"""Device selection: CUDA by default, the CPU only when asked for."""
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means CUDA. A CUDA device without a usable card raises: the
    caller must ask for ``device="cpu"`` explicitly to run on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is False); "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
