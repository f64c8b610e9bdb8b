"""The Gaussian store as the render path reads it.

Counterpart of `l2_normalize`, the aux fields that rendering reads, and
`get_gaussians` in `wildgaussians_tpu/models/gaussian_store.py`. The store
keeps the JAX package's fixed capacity with an `alive` mask, so that a
checkpoint's slots map one to one.
"""
from typing import Dict, NamedTuple

import torch

from ..ops.gaussians import apply_3d_filter


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics."""
    return x / torch.clamp_min(torch.linalg.norm(x, dim=dim, keepdim=True), eps)


class AuxState(NamedTuple):
    """Per-Gaussian buffers the render path reads."""
    alive: torch.Tensor             # [C] bool
    filter_3D: torch.Tensor         # [C,1]
    active_sh_degree: torch.Tensor  # [] int


def get_gaussians(params: Dict[str, torch.Tensor], aux: AuxState) -> Dict[str, torch.Tensor]:
    """Activated Gaussians with the 3D filter fused."""
    rotations = l2_normalize(params["rotations"])
    features = params["features_dc"]
    if "features_rest" in params:
        features = torch.cat([features, params["features_rest"]], dim=-1)
    raw_scales = torch.exp(params["scales"])
    raw_opacities = torch.sigmoid(params["opacities"])
    scales, opacities = apply_3d_filter(raw_scales, raw_opacities, aux.filter_3D)
    return {
        "xyz": params["xyz"],
        "opacities": opacities,
        "scales": scales,
        "rotations": rotations,
        "features": features,
    }
