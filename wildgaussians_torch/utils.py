"""Host-side helpers: the port's copy of `convert_image_dtype` from
`wildgaussians_tpu/utils.py`."""
import numpy as np


def convert_image_dtype(image: np.ndarray, dtype) -> np.ndarray:
    """uint8 <-> float image conversion (uint8 is [0, 255], floats [0, 1])."""
    if image.dtype == dtype:
        return image
    if image.dtype != np.uint8 and dtype != np.uint8:
        return image.astype(dtype)
    if image.dtype == np.uint8 and dtype != np.uint8:
        return image.astype(dtype) / 255.0
    if image.dtype != np.uint8 and dtype == np.uint8:
        return np.clip(image * 255.0, 0, 255).astype(np.uint8)
    raise ValueError(f"cannot convert image from {image.dtype} to {dtype}")
