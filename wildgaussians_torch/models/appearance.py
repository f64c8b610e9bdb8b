"""Per-Gaussian appearance modulation MLP (WildGaussians' EmbeddingModel).

Counterpart of `wildgaussians_tpu/models/appearance.py`: an MLP over
(base color 3 + per-Gaussian Fourier embedding 6F + image embedding E)
-> 128 -> 128 -> 6, times 0.01, giving an affine (offset, mul) of the SH
features: the offset, scaled 1/C0, touches the DC coefficients only; mul
scales every coefficient. The JAX package keeps the weights as [in, out];
`nn.Linear.weight` is [out, in] (io/convert.py transposes).

Float32 throughout; on CUDA, torch's default keeps TF32 off for matmuls.
"""
import math
from typing import Optional

import torch
from torch import nn

from ..ops.sh import C0

HIDDEN = 128


def mlp_input_dim(config) -> int:
    return config.appearance_embedding_dim + 3 + 6 * config.appearance_n_fourier_freqs


class AppearanceMLP(nn.Module):
    def __init__(self, in_dim: int):
        super().__init__()
        # out: (offset, mul) for the 3 base-color channels
        self.layers = nn.ModuleList([nn.Linear(in_dim, HIDDEN), nn.Linear(HIDDEN, HIDDEN),
                                     nn.Linear(HIDDEN, 6)])

    @classmethod
    def from_config(cls, config, generator: Optional[torch.Generator] = None) -> "AppearanceMLP":
        if config.appearance_model_sh:
            raise NotImplementedError("appearance_model_sh is not supported")
        mlp = cls(mlp_input_dim(config))
        if generator is not None:
            mlp.init_weights(generator)
        return mlp

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """nn.Linear's default init (kaiming_uniform with a=sqrt(5): weight
        and bias bounds 1/sqrt(fan_in)), drawn from `generator`."""
        for lin in self.layers:
            bound = 1.0 / math.sqrt(lin.in_features)
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.uniform_(-bound, bound, generator=generator)

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
