"""Weights and training state between the JAX package's checkpoint format
and the port.

A checkpoint is a directory with `config.yaml` and `chkpnt-<step>.npz`. The
npz holds flat keys: `params/<name>` and `params/appearance_mlp/{w,b}{0,1,2}`
for the parameter tree, `aux/<field>` for the store's buffers,
`adam/mu/<param>`, `adam/nu/<param>` and `adam/step` for Adam,
`spatial_lr_scale` and, with an uncertainty model, its head
`params/uncertainty/{conv_w,conv_b,bn_scale,bn_bias}` (with Adam's
`adam/{mu,nu}/uncertainty/...`) and its running batch-norm statistics
`uncertainty_bn/{mean,var}`. `params_from_numpy` turns the arrays a render
needs into the port's tensors and modules; `train_state_from_numpy` adds
Adam, the spatial learning-rate scale and the uncertainty model's arrays
(`uncertainty_from_numpy`) for resuming training; `state_to_numpy` writes
the port's state back in the same layout.

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
from ..models.dinov2 import ARCHS
from ..models.gaussian_store import AdamState, AuxState

# Read and ignored by the serving path: the optimizer state, the training-only
# scalars, and the uncertainty model with its batch-norm statistics (render
# never uses it).
IGNORED_PREFIXES = ("adam/", "params/uncertainty/", "uncertainty_bn/", "spatial_lr_scale")
# the densification statistics: zeros when a checkpoint lacks them
STATS_AUX = ("max_radii2D", "xyz_grad", "xyz_gradient_accum_abs",
             "xyz_gradient_accum_abs_max", "denom")


class ModelState(NamedTuple):
    params: Dict[str, torch.Tensor]   # per-Gaussian tensors + appearance_embeddings
    mlp: Optional[AppearanceMLP]      # None when appearance is disabled
    aux: AuxState


class TrainState(NamedTuple):
    model: ModelState
    adam: AdamState                   # moments keyed as `trainable_tensors`
    spatial_lr_scale: float
    uncertainty: Optional[Dict[str, torch.Tensor]] = None      # the head, or None
    uncertainty_bn: Optional[Dict[str, torch.Tensor]] = None   # running BN statistics


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


def trainable_tensors(params: Dict[str, torch.Tensor], mlp: Optional[AppearanceMLP],
                      uncertainty: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Every trained tensor under its store key (see models/gaussian_store.py):
    the parameters, then the MLP's `appearance_mlp/{w,b}{i}`, then the
    uncertainty head's `uncertainty/<name>`."""
    out = dict(params)
    if mlp is not None:
        out.update(mlp.named_tensors())
    if uncertainty is not None:
        out.update({f"uncertainty/{k}": v for k, v in uncertainty.items()})
    return out


def uncertainty_from_numpy(flat: Mapping[str, np.ndarray], config: Config, device="cpu"):
    """(head, running batch-norm statistics or None) of the uncertainty
    model from JAX-format flat arrays, or None with `uncertainty_mode:
    disabled`. Raises ValueError naming a missing or mis-shaped head key."""
    if config.uncertainty_mode == "disabled":
        return None
    d = ARCHS[config.uncertainty_backbone]["embed_dim"]
    shapes = {"conv_w": (d, 1), "conv_b": (1,), "bn_scale": (d,), "bn_bias": (d,)}
    head = {}
    for name, shape in shapes.items():
        key = f"params/uncertainty/{name}"
        if key not in flat:
            raise ValueError(f"checkpoint is missing {key!r} (uncertainty_mode "
                             f"{config.uncertainty_mode!r} trains the uncertainty head)")
        if tuple(np.shape(flat[key])) != shape:
            raise ValueError(f"checkpoint key {key!r} has shape {np.shape(flat[key])}, the "
                             f"{config.uncertainty_backbone} head {shape}")
        head[name] = torch.as_tensor(np.array(flat[key], np.float32), device=device)
    bn = None
    if "uncertainty_bn/mean" in flat:
        bn = {k: torch.as_tensor(np.array(flat[f"uncertainty_bn/{k}"], np.float32), device=device)
              for k in ("mean", "var")}
    return head, bn


def _to_jax_layout(key: str, x: np.ndarray) -> np.ndarray:
    """An MLP weight is [out, in] in the port and [in, out] in a checkpoint."""
    return x.T.copy() if key.startswith("appearance_mlp/w") else x


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
    stats = {f"aux/{name}": (capacity,) if name == "max_radii2D" else (capacity, 1)
             for name in STATS_AUX}
    for key in flat:
        if key.startswith(IGNORED_PREFIXES) or key in expected or key in stats:
            continue
        raise ValueError(f"checkpoint key {key!r} is not expected under this config")
    for key, shape in list(expected.items()) + [(k, s) for k, s in stats.items() if k in flat]:
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
        mlp = AppearanceMLP.from_config(config)
        mlp.load_jax_layout({f"{k}{i}": flat[f"params/appearance_mlp/{k}{i}"]
                             for i in range(3) for k in "wb"})
        mlp = mlp.to(device).eval()
    aux = AuxState(
        alive=t("aux/alive", torch.bool), filter_3D=t("aux/filter_3D"),
        **{name: t(key) if key in flat else torch.zeros(shape, device=device)
           for key, shape in stats.items() for name in [key[len("aux/"):]]},
        active_sh_degree=t("aux/active_sh_degree", torch.int32))
    return ModelState(params, mlp, aux)


def train_state_from_numpy(flat: Mapping[str, np.ndarray], config: Config,
                           device="cpu") -> TrainState:
    """`params_from_numpy` plus Adam's moments and step and the spatial
    learning-rate scale, as the JAX package's `_load_state` reads them.
    Raises ValueError naming a missing or mis-shaped Adam key."""
    model = params_from_numpy(flat, config, device)
    head, bn = uncertainty_from_numpy(flat, config, device) or (None, None)
    names = trainable_tensors(model.params, model.mlp, head)
    moments = {}
    for which in ("mu", "nu"):
        moments[which] = {}
        for name, p in names.items():
            key = f"adam/{which}/{name}"
            if key not in flat:
                raise ValueError(f"checkpoint is missing {key!r}: it holds no training state")
            x = _to_jax_layout(name, np.asarray(flat[key]))   # the transpose is its own inverse
            if tuple(x.shape) != tuple(p.shape):
                raise ValueError(f"checkpoint key {key!r} has shape {np.shape(flat[key])}, "
                                 f"its parameter {tuple(p.shape)}")
            moments[which][name] = torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                                                   device=device)
    for key in ("adam/step", "spatial_lr_scale"):
        if key not in flat:
            raise ValueError(f"checkpoint is missing {key!r}")
    adam = AdamState(moments["mu"], moments["nu"],
                     torch.as_tensor(np.asarray(flat["adam/step"]), dtype=torch.int32,
                                     device=device))
    return TrainState(model, adam, float(flat["spatial_lr_scale"]), head, bn)


def state_to_numpy(params: Dict[str, torch.Tensor], mlp: Optional[AppearanceMLP],
                   aux: AuxState, adam: AdamState, spatial_lr_scale: float,
                   uncertainty: Optional[Dict[str, torch.Tensor]] = None,
                   uncertainty_bn: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, np.ndarray]:
    """The port's training state as the JAX package's `_state_dict` writes
    it: `params/...` (MLP weights [in, out], the uncertainty head under
    `params/uncertainty/`), `adam/mu/...`, `adam/nu/...`, `adam/step`,
    every `aux/...` field, `spatial_lr_scale` and `uncertainty_bn/...`."""
    def host(x):
        return x.detach().cpu().numpy()
    flat = {}
    for name, p in trainable_tensors(params, mlp, uncertainty).items():
        flat[f"params/{name}"] = _to_jax_layout(name, host(p))
    for which, moments in (("mu", adam.mu), ("nu", adam.nu)):
        for name, m in moments.items():
            flat[f"adam/{which}/{name}"] = _to_jax_layout(name, host(m))
    flat["adam/step"] = host(adam.step)
    for field in AuxState._fields:
        flat[f"aux/{field}"] = host(getattr(aux, field))
    flat["spatial_lr_scale"] = np.asarray(spatial_lr_scale)
    for k, v in (uncertainty_bn or {}).items():
        flat[f"uncertainty_bn/{k}"] = host(v)
    return flat


def save_checkpoint(path: str, config: Config, flat: Mapping[str, np.ndarray],
                    step: int = 0) -> str:
    """Write `config.yaml` and `chkpnt-<step>.npz` in the JAX package's
    layout. Training-only entries missing from `flat` (the densification
    statistics, the optimizer step, the spatial LR scale) are written as
    zeros so that the JAX package loads the checkpoint too."""
    out = dict(flat)
    capacity = int(np.shape(flat["params/xyz"])[0])
    for name in STATS_AUX:
        shape = (capacity,) if name == "max_radii2D" else (capacity, 1)
        out.setdefault(f"aux/{name}", np.zeros(shape, np.float32))
    out.setdefault("adam/step", np.asarray(0, np.int32))
    out.setdefault("spatial_lr_scale", np.asarray(1.0, np.float32))
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, f"chkpnt-{step}.npz"), **out)
    with open(os.path.join(path, "config.yaml"), "w", encoding="utf8") as f:
        f.write(config_to_yaml(config))
    return path
