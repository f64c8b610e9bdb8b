"""The fixed-capacity Gaussian store: parameters, Adam, and the per-Gaussian
buffers of the render path and of densification.

Counterpart of `wildgaussians_tpu/models/gaussian_store.py`. The store
keeps the JAX package's fixed capacity with an `alive` mask, so that a
checkpoint's slots map one to one and an init from the same seed and points
gives the same arrays: densify writes clones and split children into free
slots, prune clears alive bits, and capacity growth pads every per-Gaussian
tensor with dead slots (new tensors, which the trainer rebinds).

Parameters are a flat dict of tensors. The per-Gaussian tensors and the
image embeddings are keyed as in the JAX package; the appearance MLP's
`nn.Linear` weights join it as `appearance_mlp/w{i}` and `appearance_mlp/b{i}`
in `nn.Linear`'s [out, in] layout (io/convert.py transposes to and from the
checkpoint's [in, out]). Adam keeps one moment of each, and updates the
parameters and moments in place (the JAX package returns new arrays).
"""
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops.gaussians import apply_3d_filter, quat_to_rotmat

_MIN_OPACITY = 0.005   # densify_and_prune prunes live slots below this activated opacity


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics."""
    return x / torch.clamp_min(torch.linalg.norm(x, dim=dim, keepdim=True), eps)


class AuxState(NamedTuple):
    """Non-differentiable per-Gaussian buffers."""
    alive: torch.Tensor                       # [C] bool
    filter_3D: torch.Tensor                   # [C,1]
    max_radii2D: torch.Tensor                 # [C]
    xyz_grad: torch.Tensor                    # [C,1] accumulated |grad_xy| (NDC units)
    xyz_gradient_accum_abs: torch.Tensor      # [C,1]
    xyz_gradient_accum_abs_max: torch.Tensor  # [C,1]
    denom: torch.Tensor                       # [C,1]
    active_sh_degree: torch.Tensor            # [] int32


class AdamState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    step: torch.Tensor   # [] int32, shared by the groups (torch's per-group step)


def init_aux(capacity: int, device="cpu") -> AuxState:
    def z1():
        return torch.zeros((capacity, 1), dtype=torch.float32, device=device)
    return AuxState(
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        filter_3D=z1(),
        max_radii2D=torch.zeros((capacity,), dtype=torch.float32, device=device),
        xyz_grad=z1(),
        xyz_gradient_accum_abs=z1(),
        xyz_gradient_accum_abs_max=z1(),
        denom=z1(),
        active_sh_degree=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_adam(params: Dict[str, torch.Tensor]) -> AdamState:
    def zeros():
        return {k: torch.zeros_like(v, requires_grad=False) for k, v in params.items()}
    step = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)
    return AdamState(mu=zeros(), nu=zeros(), step=step)


def param_learning_rates(config: Config, spatial_lr_scale: float, step) -> Dict[str, object]:
    """Per-group learning rates at the 1-indexed iteration `step`: the
    exponential position schedule (in f32, as the JAX package computes it)
    and a constant for every other group."""
    step = torch.as_tensor(step, dtype=torch.float32)
    t = torch.clamp(step / config.position_lr_max_steps, 0.0, 1.0)
    lr_init = config.position_lr_init * spatial_lr_scale
    lr_final = config.position_lr_final * spatial_lr_scale
    xyz_lr = torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    lrs = {
        "xyz": xyz_lr,
        "features_dc": config.feature_lr,
        "opacities": config.opacity_lr,
        "scales": config.scaling_lr,
        "rotations": config.rotation_lr,
    }
    if config.sh_degree > 0:
        lrs["features_rest"] = config.feature_lr / 20.0
    if config.appearance_enabled:
        lrs["appearance_embeddings"] = config.appearance_embedding_lr
        lrs["embeddings"] = config.embedding_lr
        lrs["appearance_mlp"] = config.appearance_mlp_lr
    if config.uncertainty_mode != "disabled":
        lrs["uncertainty"] = config.uncertainty_lr
    return lrs


@torch.no_grad()
def adam_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: AdamState, lrs: Dict[str, object], b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15,
                weight_decay: Optional[Dict[str, float]] = None) -> AdamState:
    """torch.optim.Adam(eps=1e-15) with per-group weight decay, IN PLACE on
    `params` and the moments; returns the state with its step advanced.
    A key `group/name` takes the learning rate of `group`. The operations
    and their order are the JAX package's `adam_update`."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    for k, p in params.items():
        group = k.split("/")[0]
        lr = lrs[group]   # a float, or a 0-d CPU tensor (usable with any device)
        g = grads[k]
        wd = (weight_decay or {}).get(group, 0.0)
        if wd:
            g = g + wd * p
        mu = b1 * state.mu[k] + (1 - b1) * g
        nu = b2 * state.nu[k] + (1 - b2) * torch.square(g)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        state.mu[k].copy_(mu)
        state.nu[k].copy_(nu)
        p.copy_(p - lr * update)
    return AdamState(state.mu, state.nu, step)


def fourier_features(xyz: np.ndarray, num_features: int = 3) -> np.ndarray:
    """Per-Gaussian Fourier position features (host numpy)."""
    xyz = xyz - xyz.mean(axis=0, keepdims=True)
    q = np.quantile(np.abs(xyz), 0.97, axis=0)
    xyz = xyz / q * 0.5 + 0.5
    freqs = np.repeat(2 ** np.linspace(0, num_features - 1, num_features,
                                       dtype=np.float32), 2)
    offsets = np.array([0, 0.5 * math.pi] * num_features, np.float32)
    feat = xyz[..., None] * freqs[None, None] * 2 * math.pi + offsets[None, None]
    return np.sin(feat).reshape(xyz.shape[0], -1).astype(np.float32)


def init_params_from_points(config: Config, xyz: np.ndarray, colors_u8: np.ndarray,
                            opacities: Optional[np.ndarray], capacity: int,
                            num_images: int, knn_dist2: np.ndarray,
                            rng: np.random.Generator, device="cpu"
                            ) -> Tuple[Dict[str, torch.Tensor], AuxState]:
    """The padded parameters from a point cloud, drawn from `rng` in the JAX
    package's order (a slot permutation, then the Fourier-embedding noise,
    then the image embeddings): scales log(sqrt(3-NN mean dist^2)),
    identity rotations, logit opacities, raw-RGB DC features, Fourier
    per-Gaussian embeddings. Slots [n, capacity) are dead and zero."""
    n = xyz.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points > capacity {capacity}")

    # seeded slot shuffle, as in the JAX package (there it balances the
    # sharded engine's contiguous blocks; it also fixes the slot order)
    perm = rng.permutation(n)
    xyz = xyz[perm]
    colors_u8 = colors_u8[perm]
    knn_dist2 = np.asarray(knn_dist2)[perm]
    if opacities is not None:
        opacities = np.asarray(opacities)[perm]

    def pad(x, width):
        out = np.zeros((capacity, width), np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=device)

    if opacities is None:
        opacities = 0.1 * np.ones(n, np.float32)
    op_logit = np.log(opacities / (1 - opacities)).astype(np.float32)[:, None]
    d2 = np.clip(knn_dist2, 1e-7, None)
    log_scales = np.repeat(np.log(np.sqrt(d2))[:, None], 3, axis=1)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0

    params = {
        "xyz": pad(xyz.astype(np.float32), 3),
        "features_dc": pad(colors_u8.astype(np.float32) / 255.0, 3),
        "scales": pad(log_scales, 3),
        "rotations": pad(rots, 4),
        "opacities": pad(op_logit, 1),
    }
    if config.sh_degree > 0:
        params["features_rest"] = torch.zeros(
            (capacity, ((config.sh_degree + 1) ** 2 - 1) * 3), dtype=torch.float32, device=device)
    if config.appearance_enabled:
        emb = fourier_features(xyz.astype(np.float32),
                               num_features=config.appearance_n_fourier_freqs)
        emb = emb + rng.normal(0, 0.0001, emb.shape).astype(np.float32)
        if not config.appearance_init_fourier:
            emb = rng.normal(0, 0.01, emb.shape).astype(np.float32)
        params["embeddings"] = pad(emb, emb.shape[1])
        params["appearance_embeddings"] = torch.as_tensor(
            rng.normal(0, 0.01, (num_images, config.appearance_embedding_dim)).astype(np.float32),
            device=device)

    aux = init_aux(capacity, device)
    aux = aux._replace(alive=torch.arange(capacity, device=device) < n)
    return params, aux


def get_gaussians(params: Dict[str, torch.Tensor], aux: AuxState) -> Dict[str, torch.Tensor]:
    """Activated Gaussians with the 3D filter fused (differentiable in the
    parameters)."""
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


@torch.no_grad()
def compute_3d_filter(xyz: torch.Tensor, alive: torch.Tensor, poses: torch.Tensor,
                      intrinsics: torch.Tensor, image_sizes: torch.Tensor) -> torch.Tensor:
    """Mip-splatting 3D filter [C,1] from each Gaussian's nearest camera
    depth. poses [M,3,4] camera-to-world; intrinsics [M,4]; image_sizes
    [M,2] float."""
    c = xyz.shape[0]
    distance = torch.full((c,), 1e5, dtype=torch.float32, device=xyz.device)
    valid_points = torch.zeros((c,), dtype=torch.bool, device=xyz.device)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=poses.dtype, device=poses.device)
    for pose, intr, size in zip(poses, intrinsics, image_sizes):
        w2c = torch.linalg.inv(torch.cat([pose, bottom], 0))
        R, T = w2c[:3, :3], w2c[:3, 3]
        xyz_cam = torch.stack([xyz[:, 0] * R[i, 0] + xyz[:, 1] * R[i, 1] + xyz[:, 2] * R[i, 2]
                               for i in range(3)], dim=-1) + T[None]
        z = xyz_cam[:, 2]
        valid_depth = z > 0.2
        zc = torch.clamp_min(z, 0.001)
        fx, fy = intr[0], intr[1]
        w, h = size[0], size[1]
        x = xyz_cam[:, 0] / zc * fx + w / 2.0
        y = xyz_cam[:, 1] / zc * fy + h / 2.0
        in_screen = (x >= -0.15 * w) & (x <= 1.15 * w) & (y >= -0.15 * h) & (y <= 1.15 * h)
        valid = valid_depth & in_screen & alive
        distance = torch.where(valid, torch.minimum(distance, zc), distance)
        valid_points = valid_points | valid
    focal = torch.max(intrinsics[:, 0])
    max_valid = torch.max(torch.where(valid_points, distance, -torch.inf))
    max_valid = torch.where(torch.isfinite(max_valid), max_valid, 1e5)
    distance = torch.where(valid_points, distance, max_valid)
    return (distance / focal * (0.2 ** 0.5))[:, None]


@torch.no_grad()
def update_densification_stats(aux: AuxState, mean2d_grad: torch.Tensor,
                               absgrad: torch.Tensor, radii: torch.Tensor,
                               use_abs: bool) -> AuxState:
    """Accumulate the densification statistics of one step for the Gaussians
    with radius > 0. mean2d_grad [C,2] signed and absgrad [C] in the
    reference's NDC-scaled units (pixel gradients x 0.5 W, 0.5 H)."""
    vis = radii > 0
    gnorm = torch.linalg.norm(mean2d_grad, dim=-1, keepdim=True)
    aux = aux._replace(
        xyz_grad=aux.xyz_grad + torch.where(vis[:, None], gnorm, 0.0),
        denom=aux.denom + torch.where(vis[:, None], 1.0, 0.0),
        max_radii2D=torch.where(vis, torch.maximum(aux.max_radii2D, radii.to(torch.float32)),
                                aux.max_radii2D),
    )
    if use_abs:
        a = absgrad[:, None]
        aux = aux._replace(
            xyz_gradient_accum_abs=aux.xyz_gradient_accum_abs + torch.where(vis[:, None], a, 0.0),
            xyz_gradient_accum_abs_max=torch.where(
                vis[:, None], torch.maximum(aux.xyz_gradient_accum_abs_max, a),
                aux.xyz_gradient_accum_abs_max),
        )
    return aux


def _masked_quantile(values: torch.Tensor, mask: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """torch.quantile (linear interpolation) over values[mask], in the JAX
    package's f32 formula: inf when the mask is empty."""
    c = values.shape[0]
    v = torch.sort(torch.where(mask, values, torch.inf)).values
    n = torch.sum(mask)
    pos = torch.clamp(q, 0.0, 1.0) * torch.clamp_min(n - 1, 0).to(torch.float32)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    vlo = v[torch.clamp(lo, 0, c - 1)]
    vhi = v[torch.clamp(hi, 0, c - 1)]
    out = vlo + (pos - lo.to(torch.float32)) * (vhi - vlo)
    return torch.where(n > 0, out, torch.inf)


def _free_slot_table(alive: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table, n_free): table[r] is the slot of the r-th free slot for r <
    n_free, and c past it."""
    c = alive.shape[0]
    free = ~alive
    rank = torch.cumsum(free, 0) - 1
    table = torch.full((c,), c, dtype=torch.int64, device=alive.device)
    table[rank[free]] = torch.arange(c, device=alive.device)[free]
    return table, torch.sum(free)


def per_gaussian_keys(params: Dict[str, torch.Tensor]):
    """The per-Gaussian parameter tensors' keys: every [C, ...] tensor of the
    store but the per-image `appearance_embeddings` (the MLP is not in
    `params`)."""
    c = params["xyz"].shape[0]
    return [k for k, v in params.items()
            if k != "appearance_embeddings" and v.dim() == 2 and v.shape[0] == c]


def split_normals(c: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two [c, 3] standard normals that place a split's two children,
    drawn from `generator` on its device."""
    def draw():
        return torch.randn((c, 3), generator=generator, device=generator.device)
    return draw(), draw()


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def densify_and_prune(params: Dict[str, torch.Tensor], adam: AdamState, aux: AuxState,
                      config: Config, extent: float, enable_size_pruning: bool,
                      generator: torch.Generator):
    """Clone, split and prune on the fixed-capacity store, as the JAX
    package's `densify_and_prune`: IN PLACE on the parameters and Adam's
    moments; returns (params, adam, aux, stats).

    Selected: alive slots whose mean 2D gradient reaches
    `densify_grad_threshold` (with `use_gof_abs_gradient`, also those whose
    mean abs gradient reaches the (1 - share selected) quantile of the alive
    slots'). A selected slot with max scale <= percent_dense * extent is
    cloned (its raw parameters copied), a larger one split: child A
    overwrites the parent, child B takes a free slot, each placed at the
    parent's rotation applied to (normal draw * scales) with scales / 1.6.
    Targets are the free slots in clone-then-split rank order; a selection
    past the last free slot is dropped. Adam's moments and the densification
    buffers of every written slot are zeroed. Then prune on the new state:
    activated opacity < _MIN_OPACITY, and max scale > 0.1 extent with
    `enable_size_pruning`. Stats (0-d tensors): clones, splits, pruned,
    dropped_for_capacity, n_alive."""
    alive = aux.alive
    c = alive.shape[0]
    dev = alive.device
    denom = torch.clamp_min(aux.denom, 1e-12)
    grads = torch.nan_to_num(aux.xyz_grad / denom)[:, 0]
    sel = grads >= config.densify_grad_threshold
    if config.use_gof_abs_gradient:
        ratio = torch.sum(sel & alive) / torch.clamp_min(torch.sum(alive), 1)
        grads_abs = torch.nan_to_num(aux.xyz_gradient_accum_abs / denom)[:, 0]
        q_thresh = _masked_quantile(grads_abs, alive, 1.0 - ratio)
        sel = sel | (grads_abs >= q_thresh)
    sel = sel & alive

    scales_act = torch.exp(params["scales"])
    max_scale = torch.amax(scales_act, dim=1)
    # the thresholds in f32, as the JAX package forms them from an f32 extent
    dense_scale = _f32(config.percent_dense, dev) * _f32(extent, dev)
    clone_sel = sel & (max_scale <= dense_scale)
    split_sel = sel & (max_scale > dense_scale)

    table, n_free = _free_slot_table(alive)
    n_clone = torch.sum(clone_sel)
    clone_rank = torch.cumsum(clone_sel, 0) - 1
    split_rank = n_clone + torch.cumsum(split_sel, 0) - 1
    clone_ok = clone_sel & (clone_rank < n_free)
    split_ok = split_sel & (split_rank < n_free)
    clone_src = torch.nonzero(clone_ok)[:, 0]
    split_src = torch.nonzero(split_ok)[:, 0]
    clone_tgt = table[clone_rank[clone_src]]
    split_tgt = table[split_rank[split_src]]

    eps_a, eps_b = split_normals(c, generator)
    stds = scales_act[split_src]
    rots = quat_to_rotmat(l2_normalize(params["rotations"][split_src]))
    off_a = torch.einsum("nij,nj->ni", rots, eps_a[split_src] * stds)
    off_b = torch.einsum("nij,nj->ni", rots, eps_b[split_src] * stds)
    split_scales = torch.log(stds / (0.8 * 2))

    # targets are free slots and sources alive ones: every value below is
    # read before any slot it comes from is written
    keys = per_gaussian_keys(params)
    for k in keys:
        p = params[k]
        if k == "xyz":
            child_a, child_b = p[split_src] + off_a, p[split_src] + off_b
        elif k == "scales":
            child_a = child_b = split_scales
        else:
            child_a = child_b = p[split_src]
        p[clone_tgt] = p[clone_src]
        p[split_tgt] = child_b
        p[split_src] = child_a

    touched = torch.zeros((c,), dtype=torch.bool, device=dev)
    touched[clone_tgt] = True
    touched[split_tgt] = True
    touched[split_src] = True
    for k in keys:
        adam.mu[k][touched] = 0.0
        adam.nu[k][touched] = 0.0
    grown = alive.clone()
    grown[clone_tgt] = True
    grown[split_tgt] = True

    # prune on the post-densification state
    opacity_act = torch.sigmoid(params["opacities"])[:, 0]
    prune = opacity_act < _MIN_OPACITY
    if enable_size_pruning:
        new_max_scale = torch.amax(torch.exp(params["scales"]), dim=1)
        prune = prune | (new_max_scale > _f32(0.1, dev) * _f32(extent, dev))
    alive_after = grown & ~prune

    # the touched slots' densification buffers start again from zero (a new
    # slot's, and a moved parent's, are stale)
    def zeroed(x):
        return torch.where(touched.view(-1, *([1] * (x.dim() - 1))), 0.0, x)
    aux = aux._replace(
        alive=alive_after,
        xyz_grad=zeroed(aux.xyz_grad),
        xyz_gradient_accum_abs=zeroed(aux.xyz_gradient_accum_abs),
        xyz_gradient_accum_abs_max=zeroed(aux.xyz_gradient_accum_abs_max),
        denom=zeroed(aux.denom),
        max_radii2D=zeroed(aux.max_radii2D),
        filter_3D=zeroed(aux.filter_3D),
    )
    stats = {
        "clones": torch.sum(clone_ok),
        "splits": torch.sum(split_ok),
        "pruned": torch.sum(grown & prune),
        "dropped_for_capacity": torch.sum(clone_sel & ~clone_ok) + torch.sum(split_sel & ~split_ok),
        "n_alive": torch.sum(alive_after),
    }
    return params, adam, aux, stats


def _reset_coefficient(g: Dict[str, torch.Tensor], aux: AuxState) -> torch.Tensor:
    """[C, 1]: the coefficient `reset_opacity` divides by, the 3D filter's
    opacity factor taken once more over the already filtered scales (as the
    JAX package takes it), floored at 1e-12."""
    s2 = torch.square(g["scales"])
    det1 = s2[:, 0] * s2[:, 1] * s2[:, 2]
    s2f = s2 + torch.square(aux.filter_3D)
    det2 = s2f[:, 0] * s2f[:, 1] * s2f[:, 2]
    return torch.clamp_min(torch.sqrt(det1 / torch.clamp_min(det2, 1e-30))[:, None], 1e-12)


@torch.no_grad()
def reset_capped_opacity(params: Dict[str, torch.Tensor], aux: AuxState) -> torch.Tensor:
    """[C]: what `reset_opacity` caps at 0.01, the activated opacity (before
    the filter) times the reset's coefficient."""
    g = get_gaussians(params, aux)
    return (torch.sigmoid(params["opacities"]) * _reset_coefficient(g, aux))[:, 0]


@torch.no_grad()
def reset_opacity(params: Dict[str, torch.Tensor], adam: AdamState, aux: AuxState):
    """Opacity reset through the 3D filter, as the JAX package's
    `reset_opacity`: the activated (filtered) opacity capped at 0.01, divided
    by `_reset_coefficient`, clipped to (1e-6, 1 - 1e-6) and written back as
    a logit; the opacities' Adam moments zeroed. IN PLACE; returns (params,
    adam). Since the coefficient is below 1, the activated opacity before
    the filter may end above 0.01; `reset_capped_opacity` is at most 0.01."""
    g = get_gaussians(params, aux)
    op_new = torch.clamp_max(g["opacities"], 0.01) / _reset_coefficient(g, aux)
    op_new = torch.clamp(op_new, 1e-6, 1 - 1e-6)
    params["opacities"].copy_(torch.log(op_new / (1 - op_new)))
    adam.mu["opacities"].zero_()
    adam.nu["opacities"].zero_()
    return params, adam


@torch.no_grad()
def grow_capacity(params: Dict[str, torch.Tensor], adam: AdamState, aux: AuxState,
                  new_capacity: int):
    """The store at `new_capacity` slots, as the JAX package's
    `grow_capacity`: every per-Gaussian parameter, its Adam moments and
    every per-Gaussian aux buffer padded with dead, zero slots (never
    `appearance_embeddings` or the MLP's moments). Returns NEW tensors
    (parameters keep their `requires_grad`); the caller rebinds whatever
    held the old ones."""
    c = aux.alive.shape[0]
    if new_capacity <= c:
        raise ValueError(f"grow_capacity: {new_capacity} <= the capacity {c}")
    keys = per_gaussian_keys(params)

    def padded(x):
        return torch.cat([x.detach(), x.new_zeros((new_capacity - c, *x.shape[1:]))])
    params = {k: padded(v).requires_grad_(v.requires_grad) if k in keys else v
              for k, v in params.items()}
    adam = AdamState(*[{k: padded(v) if k in keys else v for k, v in m.items()}
                       for m in (adam.mu, adam.nu)], step=adam.step)
    aux = AuxState(*[padded(x) if x.dim() >= 1 and x.shape[0] == c else x for x in aux])
    return params, adam, aux
