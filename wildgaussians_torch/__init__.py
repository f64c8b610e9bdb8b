"""WildGaussians in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The WildGaussians method: train a scene from a dataset (the `train` CLI:
`python -m wildgaussians_torch.train`), evaluate it, and serve renders of a
checkpoint. Module names follow the JAX package
(`wildgaussians_tpu`) so that each piece has a counterpart of the same name;
this package imports nothing of it.

Entry points run on CUDA unless the caller passes ``device="cpu"``. Without a
card and without ``device="cpu"`` they raise; they never carry on on the CPU.
"""

__version__ = "0.1.0"

from .config import Config, load_config_yaml, merge_config  # noqa: F401
from .device import resolve_device  # noqa: F401
from .types import (Cameras, RenderOutput, camera_model_to_int,  # noqa: F401
                    new_cameras)


def __getattr__(name):
    # heavy imports on demand (keep `import wildgaussians_torch` light)
    if name == "WildGaussians":
        from .models.wildgaussians import WildGaussians
        return WildGaussians
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
