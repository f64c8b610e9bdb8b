"""Scene render: activations + SH + appearance + rasterize.

Counterpart of `render_internal` in `wildgaussians_tpu/models/renderer.py`:
builds the camera on the device, evaluates SH colors, optionally tones them
through the appearance MLP, and blends up to three color passes (raw /
toned / depth) over one shared preprocess and binning. `rasterizer_backend`
`pallas` or `auto` runs the JAX package's pallas backend with pack16 off:
the sort engine (with the saturation cull under a map, `sat_super`), or the
partition or gather engine (`pallas_binning: partition` or `gather`),
or under a mesh (`parallel.mesh.current_mesh()`) their sharded paths (the
JAX renderer passes its mesh and the config's `pallas_send_beta` and
`shard_gaussian_store` alike);
`tiled` runs its tiled backend: `bin_gaussians` with `depth_sort_mode` and
the plain-torch `rasterize_tiled` once per pass. Differentiable: with grad
enabled the blend runs its backward, and the two zero hooks of training
receive the gradients of the densification statistics.
"""
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..cameras import make_camera_params_torch
from ..config import Config
from ..ops.binning import bin_gaussians
from ..ops.blend import engine_binning, rasterize_multi
from ..ops.gaussians import compute_cov3d, preprocess
from ..ops.partition_engine import engine_d_small
from ..ops.rasterize import engine_overflow_count
from ..ops.rasterize_tiled import make_grid, rasterize_tiled
from ..ops.sh import eval_sh_switch
from ..parallel.mesh import all_gather_cat, all_reduce_, current_mesh
from ..spans import span
from .appearance import AppearanceMLP


class RenderPkg(NamedTuple):
    render: torch.Tensor            # [H,W,3] (toned if appearance enabled)
    raw_render: torch.Tensor        # [H,W,3]
    accumulation: torch.Tensor      # [H,W] = 1 - final_T
    radii: torch.Tensor             # [N] int32 (0 = not rendered); feeds the statistics
    depth: Optional[torch.Tensor]   # [H,W] or None
    num_rendered: torch.Tensor      # sum of (capped) tile rects
    overflow: torch.Tensor          # truncated contributions
    max_tiles: torch.Tensor         # largest raw tile rect
    blend: Dict[str, torch.Tensor]  # the blend kernel's inputs and walked counts ({} if tiled)
    # per-tile saturation depths [T] from K1's exit vote (the sort engine
    # only, else None); `pool_sat_depth` makes a later step's map of them
    sat_depth: Optional[torch.Tensor] = None
    # entries the sharded sort engine's send cap dropped, over the ranks
    # (under a mesh, else None); counted in `overflow` too
    send_drops: Optional[torch.Tensor] = None


def render_internal(gaussians: Dict[str, torch.Tensor],
                    params: Dict[str, torch.Tensor],
                    mlp: Optional[AppearanceMLP],
                    active_sh_degree,
                    alive: torch.Tensor,
                    config: Config,
                    pose: torch.Tensor, intrinsics: torch.Tensor,
                    width: int, height: int,
                    *,
                    embedding: Optional[torch.Tensor],
                    kernel_size: float,
                    render_depth: bool = False,
                    mean2d_hook: Optional[torch.Tensor] = None,
                    absgrad_hook: Optional[torch.Tensor] = None,
                    return_raw: bool = True,
                    actual_size: Optional[tuple] = None,
                    sat_super: Optional[torch.Tensor] = None) -> RenderPkg:
    """One camera render. `gaussians` are post-activation (get_gaussians).

    width/height may be the padded canvas; `actual_size` (w, h) keeps the
    tan_fov of the real image (the EWA clamp limits) and sets the NDC
    factors (0.5 w, 0.5 h) of the abs-gradient channel. `mean2d_hook` [N,2]
    (zeros) is added to the projected means, so its gradient is the
    gradient of the means in pixels; `absgrad_hook` [N,2] (zeros) receives
    the fused abs channel in channel 0 (NDC-scaled; channel 1 is 0). With
    appearance on, `return_raw=False` skips the raw pass (the toned image
    then stands in for `raw_render`, and its final_T gives `accumulation`).
    `sat_super` [sy, sx]: the saturation map the sort engine's binning culls
    under (None: no cull).

    Under a mesh with `shard_gaussian_store`, `gaussians` and `params` hold
    this rank's block of the store: the images, `num_rendered`, `overflow`
    and `max_tiles` are the whole store's, the same on every rank, and
    `radii` is the rank's block."""
    max_tiles_per_gaussian = config.max_tiles_per_gaussian
    mesh = current_mesh()
    sharded = mesh is not None and config.shard_gaussian_store
    with span("camera"):
        camera = make_camera_params_torch(pose, intrinsics, width, height)
        if actual_size is not None:
            aw, ah = actual_size
            fx, fy = intrinsics[0], intrinsics[1]
            camera = camera._replace(tan_fov=torch.stack([aw / (2.0 * fx), ah / (2.0 * fy)]).to(torch.float32))

    means3d = gaussians["xyz"]
    n = means3d.shape[0]
    opacities = gaussians["opacities"][:, 0]
    features = torch.clamp_max(gaussians["features"], 1.0)
    shdim = (config.sh_degree + 1) ** 2

    with span("sh"):
        dirs = means3d - camera.campos[None]
        dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-12)
        if features.shape[-1] == 3:
            colors = features
        else:
            shs = features.reshape(n, shdim, 3).transpose(1, 2)
            colors = torch.clamp_min(eval_sh_switch(active_sh_degree, config.sh_degree, shs, dirs) + 0.5, 0.0)

    bg = torch.zeros((3,), dtype=torch.float32, device=means3d.device)
    with span("preprocess"):
        cov3d = compute_cov3d(gaussians["scales"], gaussians["rotations"])
        pre = preprocess(means3d, cov3d, opacities, camera, width, height,
                         kernel_size, tile_size=16, alive=alive)
        if mean2d_hook is not None:
            pre = pre._replace(mean2d=pre.mean2d + mean2d_hook)
    grid = make_grid(width, height, 16)

    passes = []
    want_raw = (not config.appearance_enabled
                or (config.appearance_separate_tuned_color and return_raw))
    if want_raw:
        passes.append(("raw", colors))
    if config.appearance_enabled:
        if embedding is None or mlp is None:
            raise ValueError("appearance is enabled: an embedding and the MLP are required")
        with span("appearance"):
            emb_expanded = embedding[None].expand(n, embedding.shape[0])
            toned = torch.clamp_max(mlp(params["embeddings"], emb_expanded, features), 1.0)
            shs_t = torch.clamp_max(toned.reshape(n, shdim, 3).transpose(1, 2), 1.0)
            colors_toned = torch.clamp_min(
                eval_sh_switch(active_sh_degree, config.sh_degree, shs_t, dirs) + 0.5, 0.0)
        passes.append(("toned", colors_toned))
    depth_norm = None
    if render_depth:
        with span("depth_colors"):
            dist_c = torch.linalg.norm(means3d - camera.campos[None], dim=-1)
            # the depth pass is normalized by its largest valid distance, as
            # in the JAX package (compositing is linear in color; the scale
            # is re-applied to the blended image below)
            depth_max = torch.max(torch.where(pre.valid, dist_c, 0.0))
            if sharded:
                depth_max = all_reduce_(depth_max.clone(), mesh, dist.ReduceOp.MAX)
            depth_norm = depth_max + 1e-6
            passes.append(("depth", (dist_c / depth_norm)[:, None].repeat(1, 3)))

    # NDC factors of the reference's abs-gradient channel (0.5 W, 0.5 H)
    if actual_size is not None:
        ndc_scale = (0.5 * float(actual_size[0]), 0.5 * float(actual_size[1]))
    else:
        ndc_scale = (0.5 * width, 0.5 * height)
    binning = engine_binning(config.pallas_binning, mesh)
    d_small = config.pallas_d_small
    if binning in ("partition", "gather"):
        d_small = engine_d_small(d_small)   # the engine's floor, for the overflow count too
    big_fraction = config.pallas_big_fraction
    tiled = config.rasterizer_backend not in ("auto", "pallas")
    if tiled and sharded:
        raise ValueError("the tiled backend blends every Gaussian on one device: it does "
                         "not run on a sharded store")
    if tiled:
        with span("binning"):
            binning = bin_gaussians(pre, grid.grid_x, grid.grid_y, max_tiles_per_gaussian,
                                    sort_mode=config.depth_sort_mode)
        hook = absgrad_hook if absgrad_hook is not None else torch.zeros(
            (n, 2), dtype=torch.float32, device=means3d.device)
        # per-axis channels: pre-scaling the hook scales its gradient by
        # the NDC factors (d/dh f(h s) = s f'(h s))
        hook = hook * torch.tensor(ndc_scale, dtype=torch.float32, device=means3d.device)[None]
        blend_aux = {}
        with span("tiled_blend"):
            outs = [rasterize_tiled(pre.mean2d, pre.conic, pre.opacity, c, hook,
                                    binning.sorted_gidx, binning.tile_starts,
                                    binning.tile_counts, bg, grid=grid, chunk=256,
                                    batch_tiles=64)
                    for _tag, c in passes]
    else:
        outs, blend_aux = rasterize_multi(
            pre.mean2d, pre.conic, pre.opacity, [c for _tag, c in passes],
            pre.depth, pre.rect_min, pre.rect_max, pre.tiles_touched, pre.valid, bg,
            grid=grid, max_tiles_per_gaussian=max_tiles_per_gaussian,
            d_small=d_small, big_fraction=big_fraction, binning=binning,
            absgrad_hook=absgrad_hook, ndc_scale=ndc_scale, sat_super=sat_super,
            mesh=mesh, send_beta=config.pallas_send_beta, grads_sharded=sharded)
    results = dict(zip([tag for tag, _c in passes], outs))

    raw_img = results["raw"][0] if "raw" in results else None
    accumulation = (1.0 - results["raw"][1] if "raw" in results
                    else 1.0 - results["toned"][1])
    rendered = results["toned"][0] if "toned" in results else raw_img
    if raw_img is None:
        raw_img = rendered
    depth = (results["depth"][0][..., 0] * depth_norm
             if "depth" in results else None)

    tiles_touched, valid, vis_count = pre.tiles_touched, pre.valid, blend_aux.get("vis_count")
    # the whole store's counts, as the JAX package's global arrays give: the
    # sharded sort engine counts the visible cells of the rank's own block
    if mesh is not None and binning == "sort" and not tiled:
        vis_count = all_gather_cat(vis_count, mesh)
    if sharded:
        tiles_touched = all_gather_cat(tiles_touched, mesh)
        valid = all_gather_cat(valid, mesh)
    num_rendered = torch.sum(torch.clamp_max(tiles_touched, max_tiles_per_gaussian))
    send_drops = blend_aux.get("send_drops")
    if tiled:
        overflow = torch.sum(tiles_touched > max_tiles_per_gaussian)
    else:
        overflow = engine_overflow_count(tiles_touched, vis_count,
                                         max_tiles_per_gaussian, d_small=d_small,
                                         big_fraction=big_fraction,
                                         binning=binning, valid=valid)
        if send_drops is not None:
            # the sharded engine's send-cap drops are truncated contributions too
            overflow = overflow + send_drops
    return RenderPkg(render=rendered, raw_render=raw_img,
                     accumulation=accumulation, radii=pre.radius,
                     depth=depth, num_rendered=num_rendered, overflow=overflow,
                     max_tiles=torch.max(torch.where(valid, tiles_touched, 0)),
                     blend=blend_aux, sat_depth=blend_aux.get("sat_depth"),
                     send_drops=send_drops)
