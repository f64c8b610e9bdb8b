"""Import a checkpoint of the reference WildGaussians (PyTorch) into the
JAX package's checkpoint format, which the port loads.

The port's copy of `wildgaussians_tpu/io/reference_import.py`. The
reference's `chkpnt-<step>.pth` is its `GaussianModel.state_dict()`: flat
tensors xyz / features_dc / features_rest / scales / rotations / opacities
/ embeddings / appearance_embeddings, the buffers (filter_3D, max_radii2D,
denom, xyz_grad, xyz_gradient_accum_abs{,_max}, active_sh_degree,
spatial_lr_scale), the appearance MLP under `appearance_mlp.mlp.N.*`, the
uncertainty head under `uncertainty_model.*`, and an `optimizer` entry with
per-group Adam state.

`import_reference_checkpoint(src, dst)` writes `dst/chkpnt-<step>.npz` (the
fixed-capacity padded store, keys as io/convert.py describes them) and
`dst/config.yaml`, the same files the JAX package's importer writes, so
that `WildGaussians(checkpoint=dst)` renders, fits embeddings and
evaluates published reference weights. Nothing is downloaded: the
checkpoint must be on disk.
"""
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import _FIELD_TYPES, Config, config_to_yaml, merge_config

logger = logging.getLogger(__name__)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """torch.load a chkpnt-*.pth onto the CPU and turn every tensor into a
    numpy array (the `optimizer` entry stays as it is)."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    out = {}
    for k, v in state.items():
        if k == "optimizer":
            out[k] = v  # nested dict; handled separately
        elif hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = v
    return out


def reference_config_to_ours(cfg_data: dict) -> Config:
    """Merge a reference config.yaml dict into the Config, dropping (with a
    warning) the fields this Config does not define."""
    known = {k: v for k, v in cfg_data.items() if k in _FIELD_TYPES}
    dropped = sorted(set(cfg_data) - set(known))
    if dropped:
        logger.warning("reference config fields not in this Config "
                       "(ignored): %s", dropped)
    return merge_config(Config(), known)


def reference_state_to_store(state: Dict[str, np.ndarray], config: Config,
                             capacity: Optional[int] = None):
    """Map a reference state_dict (numpy arrays) to (params, aux_arrays, extras).

    params: the padded parameter tree of the JAX package's store layout
    (MLP weights [in, out]);
    aux_arrays: dict of AuxState field -> padded array;
    extras: dict with 'spatial_lr_scale', 'step' and optional
    'uncertainty_bn' running stats.
    """
    n = state["xyz"].shape[0]
    cap = capacity or _round_up(max(int(n * 1.2), n + 1024), 256)
    assert n <= cap

    def pad(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[:, None]
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:n] = x
        return out

    params = {
        "xyz": pad(state["xyz"]),
        "features_dc": pad(state["features_dc"]),
        "scales": pad(state["scales"]),
        "rotations": pad(state["rotations"]),
        "opacities": pad(state["opacities"]),
    }
    if "features_rest" in state and state["features_rest"] is not None \
            and config.sh_degree > 0:
        params["features_rest"] = pad(state["features_rest"])
    if config.appearance_enabled:
        params["embeddings"] = pad(state["embeddings"])
        params["appearance_embeddings"] = np.asarray(
            state["appearance_embeddings"], np.float32)
        # torch Linear keeps [out, in]; the npz keeps [in, out]
        params["appearance_mlp"] = {
            "w0": np.ascontiguousarray(state["appearance_mlp.mlp.0.weight"].T),
            "b0": np.asarray(state["appearance_mlp.mlp.0.bias"], np.float32),
            "w1": np.ascontiguousarray(state["appearance_mlp.mlp.2.weight"].T),
            "b1": np.asarray(state["appearance_mlp.mlp.2.bias"], np.float32),
            "w2": np.ascontiguousarray(state["appearance_mlp.mlp.4.weight"].T),
            "b2": np.asarray(state["appearance_mlp.mlp.4.bias"], np.float32),
        }
    extras = {
        "spatial_lr_scale": float(np.asarray(state["spatial_lr_scale"])),
    }
    if config.uncertainty_mode != "disabled" \
            and "uncertainty_model.conv_seg.weight" in state:
        d = state["uncertainty_model.conv_seg.weight"].shape[1]
        params["uncertainty"] = {
            "conv_w": state["uncertainty_model.conv_seg.weight"]
            .reshape(1, d).T.astype(np.float32).copy(),
            "conv_b": np.asarray(state["uncertainty_model.conv_seg.bias"],
                                 np.float32),
            "bn_scale": np.asarray(state["uncertainty_model.bn.weight"],
                                   np.float32),
            "bn_bias": np.asarray(state["uncertainty_model.bn.bias"],
                                  np.float32),
        }
        if "uncertainty_model.bn.running_mean" in state:
            extras["uncertainty_bn"] = {
                "mean": np.asarray(
                    state["uncertainty_model.bn.running_mean"], np.float32),
                "var": np.asarray(
                    state["uncertainty_model.bn.running_var"], np.float32),
            }

    aux = {
        "alive": np.arange(cap) < n,
        "filter_3D": pad(state["filter_3D"]),
        "max_radii2D": pad(state["max_radii2D"])[:, 0],
        "xyz_grad": pad(state["xyz_grad"]),
        "xyz_gradient_accum_abs": pad(
            state.get("xyz_gradient_accum_abs", np.zeros((n, 1)))),
        "xyz_gradient_accum_abs_max": pad(
            state.get("xyz_gradient_accum_abs_max", np.zeros((n, 1)))),
        "denom": pad(state["denom"]),
        "active_sh_degree": np.asarray(
            state["active_sh_degree"], np.int32).reshape(()),
    }
    return params, aux, extras


def _adam_from_reference(optimizer: Optional[dict], params: dict):
    """Best-effort Adam moment import (the reference's parameter groups).
    Group order: xyz, features_dc, opacities, scales,
    rotations, [appearance_embeddings], [embeddings], [features_rest],
    [appearance_mlp x6], [uncertainty_model ...]. Torch state is keyed by
    global param index in that order; missing/odd entries fall back to
    zero moments (identical to the reference's fresh-optimizer path when a
    checkpoint lacks optimizer state)."""
    def zeros_like_tree(tree):
        return {k: (zeros_like_tree(v) if isinstance(v, dict)
                    else np.zeros_like(v)) for k, v in tree.items()}

    mu = zeros_like_tree(params)
    nu = zeros_like_tree(params)
    step = 0
    if not optimizer or "state" not in optimizer:
        return mu, nu, step

    # global param index -> (params-tree path)
    order = ["xyz", "features_dc", "opacities", "scales", "rotations"]
    paths = [(k,) for k in order]
    if "appearance_embeddings" in params:
        paths.append(("appearance_embeddings",))
    if "embeddings" in params:
        paths.append(("embeddings",))
    if "features_rest" in params:
        paths.append(("features_rest",))
    if "appearance_mlp" in params:
        for k in ("w0", "b0", "w1", "b1", "w2", "b2"):
            paths.append(("appearance_mlp", k))

    opt_state = optimizer["state"]
    for idx, path in enumerate(paths):
        st = opt_state.get(idx)
        if st is None:
            continue
        exp_avg = np.asarray(st["exp_avg"].detach().cpu().numpy()
                             if hasattr(st["exp_avg"], "detach")
                             else st["exp_avg"], np.float32)
        exp_sq = np.asarray(st["exp_avg_sq"].detach().cpu().numpy()
                            if hasattr(st["exp_avg_sq"], "detach")
                            else st["exp_avg_sq"], np.float32)
        step = max(step, int(np.asarray(
            st["step"].detach().cpu().numpy()
            if hasattr(st["step"], "detach") else st["step"])))
        dst_mu, dst_nu = mu, nu
        for p in path[:-1]:
            dst_mu, dst_nu = dst_mu[p], dst_nu[p]
        leaf = path[-1]
        tgt = dst_mu[leaf]
        if path[0] == "appearance_mlp" and leaf.startswith("w"):
            exp_avg, exp_sq = exp_avg.T, exp_sq.T
        if exp_avg.shape != tgt.shape:  # per-gaussian: pad to capacity
            pad_avg = np.zeros_like(tgt)
            pad_sq = np.zeros_like(tgt)
            pad_avg[:exp_avg.shape[0]] = exp_avg.reshape(
                exp_avg.shape[0], -1) if tgt.ndim == 2 else exp_avg
            pad_sq[:exp_sq.shape[0]] = exp_sq.reshape(
                exp_sq.shape[0], -1) if tgt.ndim == 2 else exp_sq
            exp_avg, exp_sq = pad_avg, pad_sq
        dst_mu[leaf] = exp_avg
        dst_nu[leaf] = exp_sq
    return mu, nu, step


def import_reference_checkpoint(src_dir: str, dst_dir: str,
                                capacity: Optional[int] = None) -> str:
    """Convert a reference checkpoint directory (config.yaml +
    chkpnt-<step>.pth, the last step if there are several) into a
    checkpoint directory of the JAX package's format. Returns dst_dir;
    `WildGaussians(checkpoint=dst_dir)` then loads it."""
    import yaml

    with open(os.path.join(src_dir, "config.yaml"), encoding="utf8") as f:
        cfg_data = yaml.safe_load(f) or {}
    config = reference_config_to_ours(cfg_data)

    steps = sorted(int(x[x.find("-") + 1:x.find(".")])
                   for x in os.listdir(src_dir) if x.startswith("chkpnt-")
                   and x.endswith(".pth"))
    if not steps:
        raise FileNotFoundError(f"no chkpnt-*.pth under {src_dir}")
    step = steps[-1]
    state = load_torch_checkpoint(os.path.join(src_dir, f"chkpnt-{step}.pth"))
    optimizer = state.pop("optimizer", None)

    params, aux, extras = reference_state_to_store(state, config, capacity)
    cap = params["xyz"].shape[0]
    mu, nu, adam_step = _adam_from_reference(optimizer, params)

    flat = {}

    def put(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(f"{prefix}{k}/", v)
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    put("params/", params)
    put("adam/mu/", mu)
    put("adam/nu/", nu)
    flat["adam/step"] = np.asarray(adam_step, np.int32)
    for k, v in aux.items():
        flat[f"aux/{k}"] = np.asarray(v)
    flat["spatial_lr_scale"] = np.asarray(extras["spatial_lr_scale"])
    if "uncertainty_bn" in extras:
        flat["uncertainty_bn/mean"] = extras["uncertainty_bn"]["mean"]
        flat["uncertainty_bn/var"] = extras["uncertainty_bn"]["var"]

    os.makedirs(dst_dir, exist_ok=True)
    np.savez(os.path.join(dst_dir, f"chkpnt-{step}.npz"), **flat)
    with open(os.path.join(dst_dir, "config.yaml"), "w", encoding="utf8") as f:
        f.write(config_to_yaml(config))
    logger.info("imported reference checkpoint step=%d n=%d capacity=%d -> %s",
                step, int(aux["alive"].sum()), cap, dst_dir)
    return dst_dir
