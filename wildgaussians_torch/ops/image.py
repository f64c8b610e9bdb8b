"""Linear image resampling: `jax.image.scale_and_translate` and
`jax.image.resize` with the triangle kernel, in torch.

The JAX package resizes with those two functions (the uncertainty model's
letterbox and its maps, the MS-SSIM scales); this module computes the same
function. Per resampled axis it builds a weight matrix [in, out]
(`weight_matrix`, JAX's `compute_weight_mat`): output sample j reads the
input at (j + 0.5) / scale - translation / scale - 0.5, through the triangle
kernel widened by 1 / scale where `antialias` asks for it and the axis is
downsampled; each column is divided by its sum (zero where the sum is at
most 1000 f32 eps), and zeroed where the sample lies outside
[-0.5, in - 0.5]. The image is then contracted with one matrix per axis.
`torch.nn.functional.interpolate` is another function: its scale comes
from the two sizes, not from a valid region, and it treats the borders
otherwise when it downsamples.

Matrices are built in f32 on the image's device from host scalars (no
copy, no wait on the device) and kept for reuse; the contraction is a
matmul (full f32 under `device.full_f32`). The JAX package runs these in
XLA, not in a Pallas kernel, so plain torch is the port.
"""
import functools
from typing import Sequence, Union

import numpy as np
import torch

Scale = Union[float, np.floating]

_SUM_FLOOR = 1000.0 * float(np.finfo(np.float32).eps)


def weight_matrix(input_size: int, output_size: int, scale: Scale, translation: float,
                  antialias: bool, device="cpu") -> torch.Tensor:
    """[input_size, output_size] f32 weights of one axis. `scale` as JAX
    forms it: a Python float has its inverse taken in double (as
    `jax.image.resize` does), an np.float32 in f32 (as a traced f32 scale
    in `scale_and_translate`). Built on `device` once per distinct
    argument set (host scalars only, so nothing waits on the device) and
    then reused: treat it as read-only."""
    if isinstance(scale, np.floating):
        inv_scale = np.float32(1.0) / np.float32(scale)
    else:
        inv_scale = np.float32(1.0 / scale)
    return _weight_matrix(int(input_size), int(output_size), float(inv_scale),
                          float(np.float32(translation) * inv_scale), bool(antialias),
                          torch.device(device))


@functools.lru_cache(maxsize=32)
def _weight_matrix(input_size: int, output_size: int, inv_scale: float, shift: float,
                   antialias: bool, device: torch.device) -> torch.Tensor:
    """`weight_matrix` from the f32 values 1 / scale and translation /
    scale (each exact in f32, so a kernel taking them as f32 arguments sees
    them unrounded); the kernel scale divides as a device tensor, a true
    division."""
    kernel_scale = torch.full((), max(inv_scale, 1.0) if antialias else 1.0,
                              dtype=torch.float32, device=device)
    sample_f = ((torch.arange(output_size, dtype=torch.float32, device=device) + 0.5) * inv_scale
                - shift - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(input_size, dtype=torch.float32,
                                                   device=device)[:, None]) / kernel_scale
    weights = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > _SUM_FLOOR,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def scale_and_translate(image: torch.Tensor, shape: Sequence[int], spatial_dims: Sequence[int],
                        scale: Sequence[Scale], translation: Sequence[float],
                        antialias: bool = True) -> torch.Tensor:
    """`jax.image.scale_and_translate(image, shape, spatial_dims, scale,
    translation, method="linear", antialias)`: output location x maps to
    input location (x - translation) / scale per spatial axis; the other
    axes of `shape` must equal the image's. Differentiable in `image`."""
    if len(shape) != image.dim():
        raise ValueError(f"shape {tuple(shape)} does not match the image's {tuple(image.shape)}")
    out = image
    for d, s, t in zip(spatial_dims, scale, translation):
        d = d % image.dim()
        w = weight_matrix(image.shape[d], shape[d], s, t, antialias, image.device)
        out = torch.matmul(out.movedim(d, -1), w).movedim(-1, d)
    return out


def resize(image: torch.Tensor, shape: Sequence[int], antialias: bool = True) -> torch.Tensor:
    """`jax.image.resize(image, shape, method="linear", antialias)`: the axes
    whose size changes are resampled with scale out / in, translation 0."""
    dims = [d for d in range(image.dim()) if image.shape[d] != shape[d]]
    scales = [1.0 if shape[d] == 0 else shape[d] / image.shape[d] for d in dims]
    return scale_and_translate(image, shape, dims, scales, [0.0] * len(dims), antialias)
