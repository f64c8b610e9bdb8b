"""Per-Gaussian appearance modulation MLP (WildGaussians' EmbeddingModel).

Counterpart of `wildgaussians_tpu/models/appearance.py`: an MLP over
(base color 3 + per-Gaussian Fourier embedding 6F + image embedding E)
-> 128 -> 128 -> 6, times 0.01, giving an affine (offset, mul) of the SH
features: the offset, scaled 1/C0, touches the DC coefficients only; mul
scales every coefficient. The JAX package keeps the weights as [in, out];
`nn.Linear.weight` is [out, in] (io/convert.py transposes).

Float32 throughout; on CUDA, torch's default keeps TF32 off for matmuls.
Training differentiates it through autograd; serving calls it in `eval()`
under `no_grad`.
"""
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.sh import C0

HIDDEN = 128


def mlp_input_dim(config) -> int:
    return config.appearance_embedding_dim + 3 + 6 * config.appearance_n_fourier_freqs


def init_mlp(rng: np.random.Generator, config) -> Dict[str, np.ndarray]:
    """The JAX package's `init_mlp`, draw for draw: for each layer a weight
    [in, out] uniform in +-sqrt(3 / fan_in), then a bias [out] uniform in
    +-1 / sqrt(fan_in), from `rng`, rounded to f32. Returns the arrays in the
    JAX package's layout (w0, b0, w1, ...)."""
    if config.appearance_model_sh:
        raise NotImplementedError("appearance_model_sh is not supported")
    dims = [mlp_input_dim(config), HIDDEN, HIDDEN, 6]
    params = {}
    for i in range(3):
        fan_in = dims[i]
        bound_w = math.sqrt(1.0 / fan_in) * math.sqrt(3.0)
        bound_b = 1.0 / math.sqrt(fan_in)
        params[f"w{i}"] = rng.uniform(-bound_w, bound_w, (dims[i], dims[i + 1])).astype(np.float32)
        params[f"b{i}"] = rng.uniform(-bound_b, bound_b, (dims[i + 1],)).astype(np.float32)
    return params


class AppearanceMLP(nn.Module):
    def __init__(self, in_dim: int):
        super().__init__()
        # out: (offset, mul) for the 3 base-color channels
        self.layers = nn.ModuleList([nn.Linear(in_dim, HIDDEN), nn.Linear(HIDDEN, HIDDEN),
                                     nn.Linear(HIDDEN, 6)])

    @classmethod
    def from_config(cls, config, rng: Optional[np.random.Generator] = None) -> "AppearanceMLP":
        if config.appearance_model_sh:
            raise NotImplementedError("appearance_model_sh is not supported")
        mlp = cls(mlp_input_dim(config))
        if rng is not None:
            mlp.load_jax_layout(init_mlp(rng, config))
        return mlp

    @torch.no_grad()
    def load_jax_layout(self, weights: Dict[str, np.ndarray]):
        """Copy weights kept in the JAX package's layout (w{i} [in, out],
        b{i} [out]) into the layers (nn.Linear holds [out, in])."""
        for i, lin in enumerate(self.layers):
            w = torch.tensor(np.asarray(weights[f"w{i}"]), dtype=torch.float32)
            lin.weight.copy_(w.T)
            lin.bias.copy_(torch.tensor(np.asarray(weights[f"b{i}"]), dtype=torch.float32))

    def named_tensors(self) -> Dict[str, torch.Tensor]:
        """The layers' parameters as the store's keys `appearance_mlp/w{i}`
        ([out, in]) and `appearance_mlp/b{i}`."""
        out = {}
        for i, lin in enumerate(self.layers):
            out[f"appearance_mlp/w{i}"] = lin.weight
            out[f"appearance_mlp/b{i}"] = lin.bias
        return out

    def forward(self, gembedding: torch.Tensor, aembedding: torch.Tensor,
                color: torch.Tensor) -> torch.Tensor:
        """color: [N, K*3] SH features; returns the toned features [N, K*3]."""
        base = color[..., :3]
        x = torch.cat([base, gembedding, aembedding], dim=-1)
        x = torch.relu(self.layers[0](x))
        x = torch.relu(self.layers[1](x))
        x = self.layers[2](x) * 0.01
        half = x.shape[-1] // 2
        offset, mul = x[..., :half], x[..., half:]
        offset = torch.cat([offset / C0, torch.zeros_like(color[..., half:])], dim=-1)
        mul = mul.repeat(1, color.shape[-1] // half)
        return color * mul + offset
