"""A resumable WildGaussians training state from the seed, in the
checkpoint layout the program reads (`config.yaml` and
`chkpnt-<step>.npz`: `params/...`, `adam/{mu,nu}/...`, `adam/step`,
`aux/...`, `spatial_lr_scale`, `uncertainty_bn/...`; MLP weights [in,
out]), and the same inputs as the reference's tensors."""
import math
import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import yaml

from reference import render as R
from reference.train import PER_GAUSSIAN, Inputs

from . import scene as S


class Made(NamedTuple):
    flat: Dict[str, np.ndarray]     # the checkpoint's arrays
    alive: np.ndarray               # [capacity] bool
    cams: List[S.Cam]
    images: List[torch.Tensor]      # device, [h, w, 3]
    vit: Optional[Dict[str, torch.Tensor]]
    points: np.ndarray              # the surfels' positions (the dataset's point cloud)


def _logit(p):
    p = p.clamp(1e-4, 1 - 1e-4)
    return torch.log(p / (1 - p))


def make(seed: int, cfg: dict, sc: dict, device, n_images: int, sizes, with_adam: bool,
         resume_step: int, training: bool = True) -> Made:
    """Everything a run starts from. `cfg` is the program's configuration
    as run, `sc` the configuration file's scene sizes. Without `training`
    there are no photos and no DINOv2 weights (a viewer needs neither)."""
    g = S.gen(seed, device)
    cams = S.cameras(n_images, sizes, device)
    surf = S.surfels(g, sc["surfel_gaussians"], device)
    skyg = S.sky(g, cfg["num_sky_gaussians"], surf.xyz, cams)
    parts = [surf, skyg]
    xyz = torch.cat([p.xyz for p in parts])
    n = xyz.shape[0]
    capacity = S.round_up(int(math.ceil(n * sc["capacity_per_live"])), 256)
    perm = torch.randperm(capacity, generator=g, device=device)
    slot_of = perm[:n]                              # live Gaussian i sits in slot slot_of[i]
    stale = torch.randint(0, n, (capacity - n,), generator=g, device=device)
    src = torch.empty(capacity, dtype=torch.long, device=device)
    src[slot_of] = torch.arange(n, device=device)
    src[perm[n:]] = stale                           # a dead slot keeps a pruned Gaussian's values
    alive = torch.zeros(capacity, dtype=torch.bool, device=device)
    alive[slot_of] = True

    def live(attr):
        return torch.cat([getattr(p, attr) for p in parts])
    F = cfg["appearance_n_fourier_freqs"]
    rest = ((cfg["sh_degree"] + 1) ** 2 - 1) * 3
    params = {
        "xyz": xyz,
        "features_dc": (live("color") - 0.5) / S.C0,
        "scales": torch.log(live("scales")),
        "rotations": live("quat"),
        "opacities": _logit(live("opacity"))[:, None],
        "features_rest": S.normal(g, (n, rest), 0.02, device),
    }
    if cfg["appearance_enabled"]:
        params["embeddings"] = S.normal(g, (n, 6 * F), 1.0, device)
    flat: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        flat[f"params/{k}"] = v[src].cpu().numpy()
    scales = sc["adam_grad_scale"]
    names = list(params)
    if cfg["appearance_enabled"]:
        e = cfg["appearance_embedding_dim"]
        flat["params/appearance_embeddings"] = S.normal(g, (n_images, e), 0.5, device).cpu().numpy()
        names.append("appearance_embeddings")
        dims = [3 + 6 * F + e, 128, 128, 6]
        for i in range(3):
            bw, bb = math.sqrt(3.0 / dims[i]), 1.0 / math.sqrt(dims[i])
            flat[f"params/appearance_mlp/w{i}"] = S.uniform(g, (dims[i], dims[i + 1]), -bw, bw,
                                                            device).cpu().numpy()
            flat[f"params/appearance_mlp/b{i}"] = S.uniform(g, (dims[i + 1],), -bb, bb,
                                                            device).cpu().numpy()
            names += [f"appearance_mlp/w{i}", f"appearance_mlp/b{i}"]
    vit = None
    if cfg["uncertainty_mode"] != "disabled" and training:
        vit = S.vit_weights(g, device)
        d = vit["norm.weight"].shape[0]
        head = {"conv_w": S.normal(g, (d, 1), sc["head_conv_std"], device),
                "conv_b": torch.full((1,), sc["head_conv_bias"], device=device),
                "bn_scale": 1.0 + S.normal(g, (d,), 0.1, device),
                "bn_bias": S.normal(g, (d,), 0.1, device)}
        for k, v in head.items():
            flat[f"params/uncertainty/{k}"] = v.cpu().numpy()
            names.append(f"uncertainty/{k}")
        flat["uncertainty_bn/mean"] = np.zeros(d, np.float32)
        flat["uncertainty_bn/var"] = np.ones(d, np.float32)
    if with_adam:
        for name in names:
            shape = flat[f"params/{name}"].shape
            s = scales[name.split("/")[0]]
            nu = (s * S.uniform(g, shape, 0.5, 2.0, device)) ** 2
            mu = S.normal(g, shape, 0.1 * s, device)
            flat[f"adam/mu/{name}"] = mu.cpu().numpy()
            flat[f"adam/nu/{name}"] = nu.cpu().numpy()
        flat["adam/step"] = np.asarray(resume_step, np.int32)
        centres = torch.stack([c.pose[:, 3] for c in cams])
        flat["spatial_lr_scale"] = np.asarray(
            float((centres - centres.mean(0)).norm(dim=1).max()) * 1.1, np.float64)
    full_cams = [R.camera(c.pose, c.intr, c.size, c.size) for c in cams]
    filt = torch.zeros((capacity, 1), device=device)
    filt[slot_of] = R.filter_3d(xyz, full_cams)
    flat["aux/alive"] = alive.cpu().numpy()
    flat["aux/filter_3D"] = filt.cpu().numpy()
    flat["aux/active_sh_degree"] = np.asarray(cfg["sh_degree"], np.int32)
    for k in ("xyz_grad", "xyz_gradient_accum_abs", "xyz_gradient_accum_abs_max", "denom"):
        flat[f"aux/{k}"] = np.zeros((capacity, 1), np.float32)
    flat["aux/max_radii2D"] = np.zeros(capacity, np.float32)
    images = S.photos(g, cams, device) if training else []
    return Made(flat, alive.cpu().numpy(), cams, images, vit, surf.xyz.cpu().numpy())


def canvas(sizes):
    """The canvas every training image is padded to: the largest width and
    height, each rounded up to 16, as the trainer pads them."""
    return tuple(S.round_up(max(s[i] for s in sizes), 16) for i in (0, 1))


def write_checkpoint(path: str, made: Made, cfg: dict, step: int):
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, f"chkpnt-{step}.npz"), **made.flat)
    with open(os.path.join(path, "config.yaml"), "w", encoding="utf8") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)


def write_vit(path: str, vit: Dict[str, torch.Tensor]):
    torch.save({k: v.cpu() for k, v in vit.items()}, path)


def reference_inputs(made: Made, cfg: dict, device, canvas) -> Inputs:
    """The reference's view of the same inputs: the live Gaussians in slot
    order, every training camera on the shared canvas."""
    alive = torch.from_numpy(made.alive).to(device)
    slots = torch.nonzero(alive).flatten()

    def t(key, rows=False):
        x = torch.from_numpy(np.asarray(made.flat[key])).to(device)
        return x[slots] if rows else x
    state = {k: t(f"params/{k}", True) for k in PER_GAUSSIAN if f"params/{k}" in made.flat}
    mlp = head = None
    if cfg["appearance_enabled"]:
        state["appearance_embeddings"] = t("params/appearance_embeddings")
        mlp = {f"{k}{i}": t(f"params/appearance_mlp/{k}{i}") for i in range(3) for k in "wb"}
    bn = None
    if "params/uncertainty/conv_w" in made.flat:
        head = {k: t(f"params/uncertainty/{k}")
                for k in ("conv_w", "conv_b", "bn_scale", "bn_bias")}
        bn = {k: t(f"uncertainty_bn/{k}") for k in ("mean", "var")}
    mu, nu = {}, {}
    for key in made.flat:
        for which, store in (("mu", mu), ("nu", nu)):
            prefix = f"adam/{which}/"
            if key.startswith(prefix):
                name = key[len(prefix):]
                store[name] = t(key, name in PER_GAUSSIAN)
    cams = [R.camera(c.pose, c.intr, canvas, c.size) for c in made.cams]
    return Inputs(state, slots, mlp, head, bn, made.vit, mu, nu,
                  int(made.flat.get("adam/step", 0)), float(made.flat.get("spatial_lr_scale", 1.0)),
                  cams, made.images)
