"""Device selection: CUDA by default, the CPU only when asked for; and the
full-f32 arithmetic every entry point runs under."""
import contextlib
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


@contextlib.contextmanager
def full_f32():
    """Within the block, f32 matmuls and cuDNN convolutions run in full f32,
    as the JAX package's `Precision.HIGHEST`, whatever the process's TF32
    flags say; the caller's flags come back on exit. (Only these two flags:
    `torch.backends.cudnn.flags(allow_tf32=False)` would also switch cuDNN
    off, its `enabled` argument defaulting to False.) A decorator too."""
    conv_tf32 = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
        torch.set_float32_matmul_precision(matmul)
