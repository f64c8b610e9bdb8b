"""Weights from the JAX package's checkpoint format into the port.

A checkpoint is a directory with `config.yaml` and `chkpnt-<step>.npz`. The
npz holds flat keys: `params/<name>` and `params/appearance_mlp/{w,b}{0,1,2}`
for the parameter tree, `aux/<field>` for the store's buffers, `adam/...`,
`spatial_lr_scale` and, with an uncertainty model, `params/uncertainty/...`
and `uncertainty_bn/...`. `params_from_numpy` turns those arrays into the
port's tensors and modules; loading a checkpoint and carrying weights across
from the JAX package in a test go through the same code.

Checked against the config: every `params/*` shape must agree with it (SH
width with `sh_degree`, the MLP's input width with the appearance fields, and
so on); a wrong config otherwise renders garbage without an error.
"""
import os
from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config, config_to_yaml
from ..models.appearance import HIDDEN, AppearanceMLP, mlp_input_dim
from ..models.gaussian_store import AuxState

# Read and ignored by the serving path: the optimizer state, the training-only
# scalars, and the uncertainty model with its batch-norm statistics (render
# never uses it).
IGNORED_PREFIXES = ("adam/", "params/uncertainty/", "uncertainty_bn/", "spatial_lr_scale")
# the aux buffers rendering does not read (densification statistics)
IGNORED_AUX = ("max_radii2D", "xyz_grad", "xyz_gradient_accum_abs",
               "xyz_gradient_accum_abs_max", "denom")


class ModelState(NamedTuple):
    params: Dict[str, torch.Tensor]   # per-Gaussian tensors + appearance_embeddings
    mlp: Optional[AppearanceMLP]      # None when appearance is disabled
    aux: AuxState


def _expected_param_shapes(config: Config, capacity: int, num_images: Optional[int]):
    shapes = {
        "params/xyz": (capacity, 3),
        "params/features_dc": (capacity, 3),
        "params/scales": (capacity, 3),
        "params/rotations": (capacity, 4),
        "params/opacities": (capacity, 1),
    }
    if config.sh_degree > 0:
        shapes["params/features_rest"] = (capacity, ((config.sh_degree + 1) ** 2 - 1) * 3)
    if config.appearance_enabled:
        shapes["params/embeddings"] = (capacity, 6 * config.appearance_n_fourier_freqs)
        shapes["params/appearance_embeddings"] = (num_images, config.appearance_embedding_dim)
        dims = [mlp_input_dim(config), HIDDEN, HIDDEN, 6]
        for i in range(3):
            shapes[f"params/appearance_mlp/w{i}"] = (dims[i], dims[i + 1])
            shapes[f"params/appearance_mlp/b{i}"] = (dims[i + 1],)
    return shapes


def params_from_numpy(flat: Mapping[str, np.ndarray], config: Config,
                      device="cpu") -> ModelState:
    """JAX-format flat arrays -> the port's tensors and modules on `device`.

    Raises ValueError naming the key when a `params/*` or `aux/*` entry is
    missing, unknown, or has a shape that disagrees with `config`."""
    if "params/xyz" not in flat:
        raise ValueError("checkpoint has no params/xyz")
    capacity = int(np.shape(flat["params/xyz"])[0])
    num_images = (int(np.shape(flat["params/appearance_embeddings"])[0])
                  if "params/appearance_embeddings" in flat else None)
    expected = _expected_param_shapes(config, capacity, num_images)
    expected.update({"aux/alive": (capacity,), "aux/filter_3D": (capacity, 1),
                     "aux/active_sh_degree": ()})
    for key in flat:
        if key.startswith(IGNORED_PREFIXES) or key in expected:
            continue
        if key.startswith("aux/") and key[len("aux/"):] in IGNORED_AUX:
            continue
        raise ValueError(f"checkpoint key {key!r} is not expected under this config")
    for key, shape in expected.items():
        if key not in flat:
            raise ValueError(f"checkpoint is missing {key!r} (expected shape {shape})")
        got = tuple(np.shape(flat[key]))
        if got != shape:
            raise ValueError(f"checkpoint key {key!r} has shape {got}, but the config "
                             f"(sh_degree={config.sh_degree}, appearance_enabled="
                             f"{config.appearance_enabled}, appearance_embedding_dim="
                             f"{config.appearance_embedding_dim}, appearance_n_fourier_freqs="
                             f"{config.appearance_n_fourier_freqs}) expects {shape}")

    def t(key, dtype=torch.float32):
        return torch.from_numpy(np.array(flat[key])).to(device=device, dtype=dtype)

    params = {key[len("params/"):]: t(key) for key in expected
              if key.startswith("params/") and "/appearance_mlp/" not in key}
    mlp = None
    if config.appearance_enabled:
        mlp = AppearanceMLP.from_config(config).to(device)
        with torch.no_grad():
            for i, lin in enumerate(mlp.layers):
                # the JAX package stores [in, out]; nn.Linear holds [out, in]
                lin.weight.copy_(t(f"params/appearance_mlp/w{i}").T)
                lin.bias.copy_(t(f"params/appearance_mlp/b{i}"))
        mlp.eval()
    aux = AuxState(alive=t("aux/alive", torch.bool),
                   filter_3D=t("aux/filter_3D"),
                   active_sh_degree=t("aux/active_sh_degree", torch.int32))
    return ModelState(params, mlp, aux)


def save_checkpoint(path: str, config: Config, flat: Mapping[str, np.ndarray]) -> str:
    """Write `config.yaml` and `chkpnt-0.npz` in the JAX package's
    layout. Training-only entries missing from `flat` (the densification
    statistics, the optimizer step, the spatial LR scale) are written as
    zeros so that the JAX package loads the checkpoint too."""
    out = dict(flat)
    capacity = int(np.shape(flat["params/xyz"])[0])
    for name in IGNORED_AUX:
        shape = (capacity,) if name == "max_radii2D" else (capacity, 1)
        out.setdefault(f"aux/{name}", np.zeros(shape, np.float32))
    out.setdefault("adam/step", np.asarray(0, np.int32))
    out.setdefault("spatial_lr_scale", np.asarray(1.0, np.float32))
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "chkpnt-0.npz"), **out)
    with open(os.path.join(path, "config.yaml"), "w", encoding="utf8") as f:
        f.write(config_to_yaml(config))
    return path
