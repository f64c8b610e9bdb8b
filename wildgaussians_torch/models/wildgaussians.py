"""WildGaussians: train from a dataset, or load a checkpoint, and render.

Counterpart of `wildgaussians_tpu/models/wildgaussians.py`: construction
(`_setup_train`, checkpoint loading), the single-device training step
(`_build_train_step`'s loss and step, with the uncertainty model of
`models/uncertainty.py` when `uncertainty_mode` is not "disabled": its loss
joins the step's, its `loss_mult` weights the L1 and DSSIM terms, its head
trains under Adam; with `saturation_culling`, each camera's saturation map
culls its step's binning and is written back from the step's render),
`train_iteration` with the host schedule after the step
(densify/prune, capacity growth, opacity reset, the protected window after
a reset), `render`, `get_embedding`, `get_train_embedding`,
`optimize_embedding` (with the uncertainty mask in its "-scaled" modes),
the Method protocol's `install`, `get_method_info` and `get_info`, and
`save` (the checkpoint and `point_cloud.ply`). Checkpoints use the JAX
package's format (see io/convert.py), both ways.

The entry points (`render_pkg` and so `render`, `train_iteration`,
`optimize_embedding`) compute in full f32 whatever the process's TF32
flags (`device.full_f32`), as the JAX package's `Precision.HIGHEST` does.

Under a mesh (`parallel.mesh.use_mesh`, around `train_iteration` or
`render`, on every rank alike) the renderer runs the sharded engines; with
`shard_gaussian_store` each rank keeps capacity / D slots of the store
(parameters, Adam's moments, the aux buffers), taken at its first entry
under the mesh. The loss, SSIM and the uncertainty model see the whole
image on every rank. A replicated tensor's gradient that sums over the
Gaussians (the appearance MLP, the image embeddings) is summed over the
ranks; one that comes from the loss alone (the uncertainty head) is the
same on every rank already. Densify/prune and capacity growth keep the
whole store's semantics: every rank gathers the store, runs them as one
device does and keeps its block again.
"""
import hashlib
import logging
import math
import os
import random
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..cameras import get_cameras_extent
from ..config import Config, config_from_yaml_str, config_to_yaml, load_config_yaml, merge_config
from ..device import full_f32, resolve_device
from ..io.convert import (params_from_numpy, state_to_numpy, train_state_from_numpy,
                          trainable_tensors, uncertainty_from_numpy)
from ..io.ply import save_ply
from ..ops.blend import check_binning
from ..ops.knn import mean_knn_dist2
from ..ops.rasterize_tiled import make_grid
from ..ops.sort_engine import pool_sat_depth, supertile_shape
from ..ops.ssim import ssim
from ..parallel.mesh import (all_gather_cat, all_reduce_, current_mesh, shard_block,
                             shard_store)
from ..spans import span
from ..types import (Cameras, Dataset, MethodInfo, ModelInfo, OptimizeEmbeddingOutput,
                     RenderOutput, camera_model_to_int)
from ..utils import convert_image_dtype
from . import gaussian_store as gs
from .appearance import AppearanceMLP
from .renderer import RenderPkg, render_internal
from .sky import get_sky_points
from .uncertainty import (DINO_SIZE, UncertaintyModel, content_mask, resize_to_valid,
                          resize_valid)

logger = logging.getLogger(__name__)

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_to(img: np.ndarray, h: int, w: int) -> np.ndarray:
    out = np.zeros((h, w, *img.shape[2:]), img.dtype)
    out[:img.shape[0], :img.shape[1]] = img
    return out


def scale_grads(values: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The forward value unchanged, the gradient scaled by `scale`."""
    return values * scale + values.detach() * (1 - scale)


def _check_supported(config: Config):
    """Raise for a configuration that names no binning engine, rather than
    run another one in its place."""
    check_binning(config.pallas_binning)


class WildGaussians:
    """The WildGaussians method on `device` (CUDA unless `device="cpu"`).

    `WildGaussians(checkpoint=path)` renders a trained checkpoint;
    `WildGaussians(train_dataset=..., config_overrides=...)` initializes
    from the dataset's point cloud and trains with `train_iteration(step)`;
    both together resume training from the checkpoint."""

    def __init__(self, *, checkpoint: Optional[str] = None,
                 train_dataset: Optional[Dataset] = None,
                 config_overrides: Optional[Dict[str, Any]] = None, device=None):
        self.device = resolve_device(device)
        self.checkpoint = checkpoint
        self.step = 0
        self._loaded_step = None
        self.config = Config()
        load_state = None
        if checkpoint is not None:
            if not os.path.isdir(checkpoint):
                raise RuntimeError(f"Model directory {checkpoint} does not exist")
            with open(os.path.join(checkpoint, "config.yaml"), encoding="utf8") as f:
                self.config = config_from_yaml_str(f.read())
            steps = sorted(int(x[x.find("-") + 1:x.find(".")])
                           for x in os.listdir(checkpoint)
                           if x.startswith("chkpnt-") and x.endswith(".npz"))
            if not steps:
                raise RuntimeError(f"no chkpnt-<step>.npz in {checkpoint}")
            self._loaded_step = self.step = steps[-1]
            with np.load(os.path.join(checkpoint, f"chkpnt-{self.step}.npz"),
                         allow_pickle=False) as npz:
                load_state = dict(npz.items())
        elif config_overrides is not None:
            config_overrides = dict(config_overrides)
            config_file = config_overrides.pop("config", "default.yml")
            self.config = merge_config(load_config_yaml(os.path.join(_CONFIG_DIR, config_file)),
                                       config_overrides)
        _check_supported(self.config)
        if self.config.appearance_model_2D != "disabled":
            raise NotImplementedError("2D appearance models are not supported")
        if self.config.use_background_model:
            raise NotImplementedError("Background model is not supported")
        if self.config.uncertainty_preserve_sky:
            raise NotImplementedError("Flag uncertainty_preserve_sky is not supported")

        # the JAX package seeds Python's global RNG with 0 for its camera
        # shuffle; the port keeps a generator of its own with that seed
        self._random = random.Random(0)
        self._np_rng = np.random.default_rng(self.config.seed)
        # the split children's normal draws (densify_and_prune)
        self._generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
        self._viewpoint_stack = []
        self.train_cameras: Optional[Cameras] = None
        self.cameras_extent: Optional[float] = None
        self._overflow_streak = 0
        self._send_drop_streak = 0
        # the mesh the store is sharded over (shard_gaussian_store), or None
        self._store_mesh = None
        # (canvas w, h) -> [n_cams, sy, sx] saturation maps (saturation_culling)
        self._sat_caches: Dict[tuple, torch.Tensor] = {}
        self.mlp: Optional[AppearanceMLP] = None
        # the uncertainty model and its head's parameters (training; a
        # checkpoint loaded to serve builds them at its first "-scaled" fit)
        self._uncertainty: Optional[UncertaintyModel] = None
        self.uparams: Optional[Dict[str, torch.Tensor]] = None
        self._uncertainty_arrays = None
        self._gt336_cache = {}

        if train_dataset is not None:
            if self.config.uncertainty_mode != "disabled":
                self._uncertainty = UncertaintyModel(self.config, self.device)
            self._setup_train(train_dataset, load_state)
        elif load_state is not None:
            self.params, self.mlp, self.aux = params_from_numpy(load_state, self.config,
                                                                self.device)
            if self.config.uncertainty_mode != "disabled":
                self._uncertainty_arrays = {
                    k: v for k, v in load_state.items()
                    if k.startswith(("params/uncertainty/", "uncertainty_bn/"))}
        else:
            raise ValueError("pass a checkpoint, a train_dataset, or both")

    # ------------------------------------------------------------------ setup

    def _setup_train(self, train_dataset: Dataset, load_state):
        points3d_xyz = train_dataset["points3D_xyz"]
        points3d_rgb = train_dataset["points3D_rgb"]
        if points3d_xyz is None or points3d_rgb is None:
            raise ValueError("the training dataset has no point cloud (points3D_xyz/rgb)")
        opacities = 0.1 * np.ones(len(points3d_xyz), np.float32)
        config = self.config
        if config.num_sky_gaussians:
            skybox, _sky_distance = get_sky_points(
                config.num_sky_gaussians, points3d_xyz, train_dataset["cameras"])
            skycolor = np.array([[237, 247, 252]], np.uint8).repeat(skybox.shape[0], axis=0)
            logger.info("Adding skybox with %d points", skybox.shape[0])
            points3d_xyz = np.concatenate([points3d_xyz, skybox])
            points3d_rgb = np.concatenate([points3d_rgb, skycolor])
            opacities = np.concatenate([opacities, np.ones(skybox.shape[0], np.float32)])

        self.cameras_extent = get_cameras_extent(train_dataset["cameras"])
        self.train_cameras = train_dataset["cameras"]
        images = train_dataset["images"]
        masks = train_dataset.get("masks")

        sizes = np.asarray(self.train_cameras.image_sizes)
        # per-camera canvas: the largest image padded to 16, or size buckets
        mult = config.size_bucket_multiple
        if mult > 0:
            self._pad_wh = [(_round_up(int(s[0]), mult), _round_up(int(s[1]), mult))
                            for s in sizes]
        else:
            pad = (_round_up(int(sizes[:, 0].max()), 16), _round_up(int(sizes[:, 1].max()), 16))
            self._pad_wh = [pad] * len(sizes)

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=self.device)
        self._train_images = [
            dev(_pad_to(convert_image_dtype(img, np.float32)[..., :3], bh, bw))
            for img, (bw, bh) in zip(images, self._pad_wh)]
        self._train_masks = None
        if masks is not None:
            self._train_masks = [
                dev(_pad_to(convert_image_dtype(m, np.float32)[..., None], bh, bw)[..., 0])
                for m, (bw, bh) in zip(masks, self._pad_wh)]
        self._pixmask = [
            dev(_pad_to(np.ones((int(s[1]), int(s[0]), 1), np.float32), bh, bw)[..., 0])
            for s, (bw, bh) in zip(sizes, self._pad_wh)]
        self._sizes = [(float(s[0]), float(s[1])) for s in sizes]
        self._poses_dev = dev(np.stack([np.asarray(c, np.float32)
                                        for c in self.train_cameras.poses]))
        self._intr_dev = dev(np.asarray(self.train_cameras.intrinsics, np.float32))
        self._sizes_dev = dev(sizes.astype(np.float32))

        if load_state is None:
            n = points3d_xyz.shape[0]
            capacity = config.initial_capacity or _round_up(
                max(int(n * config.capacity_growth_factor), n + 1024), 256)
            knn_d2 = mean_knn_dist2(dev(points3d_xyz.astype(np.float32))).cpu().numpy()
            self.params, self.aux = gs.init_params_from_points(
                config, points3d_xyz, points3d_rgb, opacities, capacity,
                len(self.train_cameras), knn_d2, self._np_rng, self.device)
            if config.appearance_enabled:
                self.mlp = AppearanceMLP.from_config(config, self._np_rng).to(self.device)
            if self._uncertainty is not None:
                # drawn after the MLP, as the JAX package draws it
                self.uparams = self._uncertainty.init_params(self._np_rng)
            self.adam = gs.init_adam(self._trainable())
            self.spatial_lr_scale = float(self.cameras_extent)
        else:
            state = train_state_from_numpy(load_state, config, self.device)
            self.params, self.mlp, self.aux = state.model
            self.adam, self.spatial_lr_scale = state.adam, state.spatial_lr_scale
            self.uparams = state.uncertainty
            if state.uncertainty_bn is not None:
                self._uncertainty.bn_state = state.uncertainty_bn
        for t in self._trainable().values():
            t.requires_grad_(True)
        self._refresh_filter()

    def _trainable(self) -> Dict[str, torch.Tensor]:
        return trainable_tensors(self.params, self.mlp, self.uparams)

    def _refresh_filter(self):
        """The 3D filter of every slot; on a sharded store from the whole
        store's positions (a Gaussian no camera sees takes the largest
        distance over all of them), this rank's block kept."""
        xyz, alive, mesh = self.params["xyz"].detach(), self.aux.alive, self._store_mesh
        if mesh is not None:
            xyz, alive = all_gather_cat(xyz, mesh), all_gather_cat(alive, mesh)
        filt = gs.compute_3d_filter(xyz, alive, self._poses_dev, self._intr_dev, self._sizes_dev)
        if mesh is not None:
            filt = filt[shard_block(filt.shape[0], mesh)]
        self.aux = self.aux._replace(filter_3D=filt)

    # ------------------------------------------------------------- train step

    def _loss(self, pkg: RenderPkg, camera_id: int, iteration: int):
        """L1 on the toned image plus lambda DSSIM on the raw image over the
        pixel mask (occluder masks scale the gradients), each pixel weighted
        by the uncertainty model's `loss_mult`, plus its loss; the metrics;
        the uncertainty model's new batch-norm statistics (or None)."""
        config = self.config
        lambda_dssim = config.lambda_dssim
        gt = self._train_images[camera_id]
        pixmask = self._pixmask[camera_id]
        mask = self._train_masks[camera_id] if self._train_masks is not None else None
        image_toned = pkg.render * pixmask[..., None]
        image = pkg.raw_render * pixmask[..., None]
        if mask is not None:
            image = scale_grads(image, mask[..., None])
            image_toned = scale_grads(image_toned, mask[..., None])
        uloss, weight, umetrics, new_bn = 0.0, pixmask, {}, None
        if self._uncertainty is not None:
            uloss, loss_mult, umetrics, new_bn = self._uncertainty_terms(image_toned, camera_id,
                                                                         iteration)
            if config.uncertainty_scale_grad:
                image = scale_grads(image, loss_mult[..., None])
                image_toned = scale_grads(image_toned, loss_mult[..., None])
            else:
                weight = loss_mult * pixmask
        npix = torch.sum(pixmask)
        l1_map = torch.abs(image_toned - gt)
        ssim_map = ssim(image, gt, size_average=False)
        l1_w = torch.sum(l1_map * weight[..., None]) / (npix * 3)
        dssim_w = torch.sum((1.0 - ssim_map) * weight) / npix
        loss = (1.0 - lambda_dssim) * l1_w + lambda_dssim * dssim_w + uloss
        with torch.no_grad():
            mse = torch.sum(torch.square(image_toned - gt) * pixmask[..., None]) / (npix * 3)
            metrics = {
                "loss": loss.detach(),
                "l1_loss": torch.sum(l1_map * pixmask[..., None]) / (npix * 3),
                "ssim": torch.sum(ssim_map * pixmask) / npix,
                "mse": mse,
                "psnr": -10.0 * torch.log10(mse),
                **umetrics,
            }
            if mask is not None:
                msum = torch.clamp_min(torch.sum(mask * pixmask), 1.0)
                mse_masked = torch.sum(torch.square(image_toned - gt)
                                       * (mask * pixmask)[..., None]) / (msum * 3)
                metrics.update({
                    "mask_percentage": torch.sum(mask * pixmask) / npix,
                    "ssim_masked": torch.sum(ssim_map * mask * pixmask) / msum,
                    "mse_masked": mse_masked,
                    "psnr_masked": -10.0 * torch.log10(mse_masked),
                    "l1_loss_masked": torch.sum(l1_map * (mask * pixmask)[..., None]) / (msum * 3),
                })
        return loss, metrics, new_bn

    def _uncertainty_terms(self, image_toned: torch.Tensor, camera_id: int, iteration: int):
        """The uncertainty model's part of a step: (its loss, detached while
        protected after an opacity reset; the per-pixel loss multiplier on
        the canvas, without gradient; its metrics; the new batch-norm
        statistics). The multiplier is the model's `loss_mult` mapped back
        to the canvas, thresholded at 1 and blended in over the warm-up
        (`uncertainty_warmup_start`, `uncertainty_warmup_iters`), optionally
        centred (`uncertainty_center_mult`)."""
        config = self.config
        unc = self._uncertainty
        pw, ph = self._pad_wh[camera_id]
        aw, ah = self._sizes[camera_id]
        pixmask = self._pixmask[camera_id]
        lb = config.uncertainty_dino_letterbox
        gt336, mask336, pmask = self._gt336_cached(camera_id)
        feats_gt = unc.gt_features(camera_id, gt336)
        pred336 = resize_valid(image_toned.detach(), DINO_SIZE, DINO_SIZE, ah, aw, letterbox=lb)
        uloss, metrics, lm336, new_bn = unc.compute_loss(
            self.uparams, unc.bn_state, feats_gt, gt336, pred336, mask336, train=True,
            generator=self._generator, patch_mask=pmask)
        with torch.no_grad():
            lm = resize_to_valid(lm336, ph, pw, ah, aw, letterbox=lb) * pixmask
            lm = (lm > 1.0).to(torch.float32)
            ws, wi = config.uncertainty_warmup_start, config.uncertainty_warmup_iters
            if iteration < ws:
                pfrac = 0.0
            elif wi > 0:
                pfrac = float(np.clip(np.float32(iteration - ws) / np.float32(wi), 0, 1))
            else:
                pfrac = 1.0
            loss_mult = 1.0 + pfrac * (lm - 1.0)
            if config.uncertainty_center_mult:
                mean_lm = torch.sum(loss_mult * pixmask) / torch.clamp_min(torch.sum(pixmask), 1.0)
                loss_mult = torch.clamp(loss_mult - (mean_lm - 1), 0, 2)
        # the head learns nothing for `uncertainty_protected_iters` after
        # each opacity reset (the host computes the window)
        last_densify = min(iteration, config.densify_until_iter - 1)
        last_reset = (last_densify // config.opacity_reset_interval) * config.opacity_reset_interval
        if iteration < last_reset + config.uncertainty_protected_iters:
            uloss = uloss.detach()
        return uloss, loss_mult, metrics, new_bn

    def _gt336_cached(self, camera_id: int):
        """A camera's ground truth letterboxed into the DINO_SIZE canvas and
        its pixel- and patch-level content masks, made on the camera's first
        visit and kept on the device."""
        cache = self._gt336_cache
        if camera_id not in cache:
            lb = self.config.uncertainty_dino_letterbox
            aw, ah = self._sizes[camera_id]
            cache[camera_id] = (
                resize_valid(self._train_images[camera_id], DINO_SIZE, DINO_SIZE, ah, aw,
                             letterbox=lb),
                content_mask(DINO_SIZE, DINO_SIZE, ah, aw, lb, device=self.device),
                content_mask(DINO_SIZE, DINO_SIZE, ah, aw, lb,
                             granularity=self._uncertainty.dino.patch_size, device=self.device))
        return cache[camera_id]

    def _use_satcull(self) -> bool:
        """The saturation cull runs on the pallas backend's single-device
        sort engine only (`auto` is pallas in the port; no mesh), as in the
        JAX package."""
        config = self.config
        return (config.saturation_culling and config.rasterizer_backend in ("auto", "pallas")
                and config.pallas_binning == "sort" and current_mesh() is None)

    def _sat_cache_for(self, pad_w: int, pad_h: int) -> torch.Tensor:
        """The per-camera saturation maps of one canvas, +inf (no cull) until
        a camera's first step records its tiles' exit depths. Cleared after
        a densify and after an opacity reset."""
        cache = self._sat_caches.get((pad_w, pad_h))
        if cache is None:
            sy, sx = supertile_shape(make_grid(pad_w, pad_h, 16))
            cache = torch.full((len(self.train_cameras), sy, sx), torch.inf,
                               dtype=torch.float32, device=self.device)
            self._sat_caches[(pad_w, pad_h)] = cache
        return cache

    def _train_step(self, camera_id: int, iteration: int, densify_enabled: bool
                    ) -> Dict[str, torch.Tensor]:
        """One step on one camera: render, loss, backward, densification
        statistics and Adam (skipped on the last iteration). Updates the
        store in place; returns the metrics as device scalars."""
        config = self.config
        pw, ph = self._pad_wh[camera_id]
        aw, ah = self._sizes[camera_id]
        n = self.params["xyz"].shape[0]
        m2d_hook = torch.zeros((n, 2), device=self.device, requires_grad=True)
        abs_hook = torch.zeros((n, 2), device=self.device, requires_grad=True)
        sat_cache = self._sat_cache_for(pw, ph) if self._use_satcull() else None
        with span("forward"):
            gaussians = gs.get_gaussians(self.params, self.aux)
            embedding = (self.params["appearance_embeddings"][camera_id]
                         if config.appearance_enabled else None)
            pkg = render_internal(
                gaussians, self.params, self.mlp, self.aux.active_sh_degree, self.aux.alive,
                config, self._poses_dev[camera_id], self._intr_dev[camera_id], pw, ph,
                embedding=embedding, kernel_size=config.kernel_size,
                mean2d_hook=m2d_hook, absgrad_hook=abs_hook, actual_size=(aw, ah),
                sat_super=sat_cache[camera_id] if sat_cache is not None else None)
        with span("loss"):
            loss, metrics, new_bn = self._loss(pkg, camera_id, iteration)
        trainable = self._trainable()
        with span("backward"):
            grads = torch.autograd.grad(loss, [*trainable.values(), m2d_hook, abs_hook],
                                        allow_unused=True)
        # a tensor the step does not reach (features_rest at SH degree 0
        # without appearance) gets a zero gradient, as under jax.grad
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip([*trainable.values(), m2d_hook, abs_hook], grads)]
        g_m2d, g_abs = grads[-2:]
        param_grads = dict(zip(trainable, grads[:-2]))
        if self._store_mesh is not None:
            self._sum_gaussian_path_grads(param_grads)
        with torch.no_grad():
            if densify_enabled:
                # the hook gradients are in pixels; the statistics take the
                # reference's NDC-scaled units (the abs channel arrives scaled)
                ndc_fac = torch.tensor([0.5 * aw, 0.5 * ah], dtype=torch.float32,
                                       device=self.device)
                self.aux = gs.update_densification_stats(
                    self.aux, g_m2d * ndc_fac[None, :], torch.sum(g_abs, dim=-1),
                    pkg.radii, config.use_gof_abs_gradient)
            # the reference skips the optimizer step on the last iteration
            if iteration < config.iterations:
                with span("adam"):
                    lrs = gs.param_learning_rates(config, self.spatial_lr_scale, iteration)
                    wd = None
                    if config.appearance_enabled and config.appearance_embedding_regularization:
                        wd = {"appearance_embeddings": config.appearance_embedding_regularization}
                    self.adam = gs.adam_update(trainable, param_grads, self.adam, lrs,
                                               weight_decay=wd)
            if new_bn is not None:
                self._uncertainty.bn_state = new_bn
            if sat_cache is not None:
                # this step's exit depths: the camera's map for its next visit
                sat_cache[camera_id] = pool_sat_depth(pkg.sat_depth, make_grid(pw, ph, 16),
                                                      margin=config.saturation_margin)
            metrics["num_rendered"] = pkg.num_rendered
            metrics["overflow"] = pkg.overflow
            metrics["send_drops"] = (pkg.send_drops if pkg.send_drops is not None
                                     else torch.zeros((), device=self.device))
            metrics["max_tiles"] = pkg.max_tiles
            metrics["num_gaussians"] = torch.sum(self.aux.alive)
            if self._store_mesh is not None:
                all_reduce_(metrics["num_gaussians"], self._store_mesh)
        return metrics

    # ------------------------------------------------------- the sharded store

    def _commit_store_to_mesh(self):
        """Under a mesh with `shard_gaussian_store`, keep this rank's
        capacity / D block of the store (the JAX package's
        `_commit_store_to_mesh`); once per mesh. Every rank calls it alike.
        A sharded store holds 1/D of the Gaussians: it raises outside its
        mesh (where a render or step would see only this rank's block)."""
        mesh = current_mesh()
        if self._store_mesh is not None:
            if mesh != self._store_mesh:
                raise RuntimeError("the store is sharded over a mesh: render and train "
                                   "inside use_mesh(that mesh)")
            return
        if mesh is None or not self.config.shard_gaussian_store:
            return
        capacity = self.aux.alive.shape[0]
        self._set_store(*self._map_store(lambda x: shard_store(x, capacity, mesh)))
        self._store_mesh = mesh

    def _set_store(self, params, adam, aux):
        self.params, self.aux = params, aux
        if adam is not None:
            self.adam = adam

    def _map_store(self, fn):
        """(params, adam, aux) with fn applied to every per-Gaussian tensor
        of the store: the parameters (keeping `requires_grad`), their Adam
        moments (adam is None without a training state) and the aux
        buffers."""
        keys = gs.per_gaussian_keys(self.params)
        with torch.no_grad():
            params = {k: fn(v.detach()).requires_grad_(v.requires_grad) if k in keys else v
                      for k, v in self.params.items()}
            adam = None
            if hasattr(self, "adam"):
                adam = gs.AdamState(*[{k: fn(v) if k in keys else v for k, v in m.items()}
                                      for m in (self.adam.mu, self.adam.nu)],
                                    step=self.adam.step)
            aux = gs.AuxState(*[fn(x) if x.dim() >= 1 else x for x in self.aux])
        return params, adam, aux

    def _whole_store(self):
        """(params, adam, aux) of the whole store: this rank's, or every
        rank's block gathered on a sharded store (every rank calls it)."""
        mesh = self._store_mesh
        if mesh is None:
            return self.params, getattr(self, "adam", None), self.aux
        return self._map_store(lambda x: all_gather_cat(x, mesh))

    def _gather_store(self):
        """The whole store on every rank, in place of this rank's block."""
        self._set_store(*self._whole_store())
        self._store_mesh = None

    def _sum_gaussian_path_grads(self, grads: Dict[str, torch.Tensor]):
        """Sum over the ranks, in place, the gradients of the replicated
        tensors that the Gaussians reach (the MLP and the image embeddings:
        each rank's is the sum over its own Gaussians). The uncertainty
        head's gradient comes from the loss, which every rank computes
        from the whole image alike: it is not summed."""
        per_gaussian = set(gs.per_gaussian_keys(self.params))
        keys = [k for k in grads if k not in per_gaussian and not k.startswith("uncertainty/")]
        if not keys:
            return
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        all_reduce_(flat, self._store_mesh)
        for k, part in zip(keys, torch.split(flat, [grads[k].numel() for k in keys])):
            grads[k] = part.view_as(grads[k])

    def _densify_schedule(self, iteration: int, densify_enabled: bool):
        """The JAX package's host schedule after a step: while densifying,
        densify/prune every `densification_interval` iterations after
        `densify_from_iter` (size pruning once past the first opacity
        reset), grow the capacity when needed and refresh the 3D filter;
        reset the opacities every `opacity_reset_interval`. Each of the two
        clears the saturation maps. Once densifying has stopped, refresh the
        filter every 100 iterations."""
        config = self.config
        if densify_enabled:
            if (iteration > config.densify_from_iter
                    and iteration % config.densification_interval == 0):
                # on a sharded store: the whole store on every rank, which
                # then runs what one device runs, with the same draws
                sharded = self._store_mesh is not None
                if sharded:
                    with span("gather_store"):
                        self._gather_store()
                with span("densify"):
                    self.params, self.adam, self.aux, stats = gs.densify_and_prune(
                        self.params, self.adam, self.aux, config, self.cameras_extent,
                        iteration > config.opacity_reset_interval, self._generator)
                self._maybe_grow_capacity(stats)
                if sharded:
                    self._commit_store_to_mesh()
                self._refresh_filter()
                self._sat_caches.clear()   # the scene changed: learn the maps again
            if iteration % config.opacity_reset_interval == 0:
                with span("reset_opacity"):
                    self.params, self.adam = gs.reset_opacity(self.params, self.adam, self.aux)
                self._sat_caches.clear()   # the opacities are reset: nothing saturates
        elif iteration % 100 == 0 and iteration < config.iterations - 100:
            self._refresh_filter()

    def _maybe_grow_capacity(self, stats: Dict[str, torch.Tensor]):
        """Grow the store when a densify dropped selections for want of free
        slots or left it above `capacity_high_watermark`: to
        `capacity_growth_factor` times the capacity plus the dropped count,
        rounded up to 256. The store's tensors are new after a growth."""
        dropped = int(stats["dropped_for_capacity"])
        n_alive = int(stats["n_alive"])
        capacity = self.aux.alive.shape[0]
        if dropped > 0 or n_alive > self.config.capacity_high_watermark * capacity:
            new_capacity = _round_up(int(capacity * self.config.capacity_growth_factor) + dropped,
                                     256)
            logger.info("Growing capacity %d -> %d (alive=%d, dropped=%d)",
                        capacity, new_capacity, n_alive, dropped)
            with span("grow_capacity"):
                self.params, self.adam, self.aux = gs.grow_capacity(
                    self.params, self.adam, self.aux, new_capacity)

    # --------------------------------------------------------------- protocol

    @classmethod
    def install(cls):
        """Method protocol hook; nothing to install."""

    @classmethod
    def get_method_info(cls) -> MethodInfo:
        return MethodInfo(
            method_id="wild-gaussians-torch",
            required_features=frozenset(("color", "points3D_xyz")),
            supported_camera_models=frozenset(("pinhole",)),
        )

    def get_info(self) -> ModelInfo:
        return ModelInfo(
            **self.get_method_info(),
            num_iterations=self.config.iterations,
            loaded_step=self._loaded_step,
        )

    @full_f32()
    def train_iteration(self, step: int, camera_id: Optional[int] = None) -> Dict[str, float]:
        """One training iteration (`step` is 0-indexed). Picks the camera
        from a shuffled stack (the JAX package's sequence) unless
        `camera_id` is given; returns the metrics as Python numbers."""
        if self.train_cameras is None:
            raise RuntimeError("the method was not constructed with a train_dataset")
        iteration = step + 1
        self.step = step
        self._commit_store_to_mesh()
        if iteration % 1000 == 0:   # SH warm-up
            self.aux = self.aux._replace(active_sh_degree=torch.clamp_max(
                self.aux.active_sh_degree + 1, self.config.sh_degree))
        if camera_id is None:
            if not self._viewpoint_stack:
                self._viewpoint_stack = list(range(len(self.train_cameras)))
            camera_id = self._viewpoint_stack.pop(
                self._random.randint(0, len(self._viewpoint_stack) - 1))
        self._last_camera_id = camera_id   # the CLI's debug snapshot names it
        densify_enabled = iteration < self.config.densify_until_iter
        metrics = self._train_step(camera_id, iteration, densify_enabled)
        self._densify_schedule(iteration, densify_enabled)
        # one host transfer for every metric (each is exact in f32)
        keys = list(metrics.keys())
        vec = torch.stack([metrics[k].to(torch.float32) for k in keys]).cpu().numpy()
        out = {k: float(v) for k, v in zip(keys, vec)}
        out["num_gaussians"] = int(out["num_gaussians"])
        self._maybe_grow_tile_budget(out["overflow"], out["send_drops"], out["max_tiles"])
        self.step = step + 1
        return out

    def _maybe_grow_tile_budget(self, overflow: float, send_drops: float = 0.0,
                                max_tiles: float = 0.0):
        """Raise the per-Gaussian tile budget (and the big-Gaussian pool)
        after 10 steps in a row with truncated contributions, as the JAX
        package does; here that only changes the config, since nothing is
        compiled per budget. Stops growing once a grow did not cut the
        overflow by 30 % or the budget reached 128. The sharded engine's
        send-cap drops (counted in `overflow` too) grow `pallas_send_beta`
        by half instead, after 10 steps in a row with drops, up to 16."""
        self._send_drop_streak = self._send_drop_streak + 1 if send_drops > 0 else 0
        if self._send_drop_streak >= 10 and self.config.pallas_send_beta < 16:
            old_beta = self.config.pallas_send_beta
            self.config.pallas_send_beta = old_beta * 1.5
            logger.info("Persistent sharded-engine send drops (%d steps): growing send_beta "
                        "%.2f -> %.2f", self._send_drop_streak, old_beta,
                        self.config.pallas_send_beta)
            self._send_drop_streak = 0
        overflow = overflow - send_drops     # the tile overflow
        self._overflow_streak = self._overflow_streak + 1 if overflow > 0 else 0
        if self._overflow_streak < 10:
            return
        self._overflow_streak = 0
        if getattr(self, "_tile_budget_saturated", False):
            return
        prev = getattr(self, "_overflow_at_last_grow", None)
        if (prev is not None and overflow > 0.7 * prev) or self.config.max_tiles_per_gaussian >= 128:
            self._tile_budget_saturated = True
            logger.warning("Rasterizer overflow persists at %d after growing the tile budget to "
                           "%d (prev overflow %s): keeping the current budget",
                           int(overflow), self.config.max_tiles_per_gaussian, prev)
            return
        self._overflow_at_last_grow = overflow
        old = self.config.max_tiles_per_gaussian
        want = int(max_tiles) if max_tiles else old * 3 // 2
        self.config.max_tiles_per_gaussian = min(max(old * 3 // 2, want) + 1, 128)
        self.config.pallas_big_fraction = min(self.config.pallas_big_fraction * 1.5, 1.0)
        logger.info("Persistent rasterizer overflow (%d): growing max_tiles_per_gaussian "
                    "%d -> %d, big_fraction -> %.3f", int(overflow), old,
                    self.config.max_tiles_per_gaussian, self.config.pallas_big_fraction)

    # ----------------------------------------------------------------- render

    def get_embedding(self, train_image_id: Optional[int] = None) -> Optional[torch.Tensor]:
        if not self.config.appearance_enabled:
            return None
        if train_image_id is not None:
            return self.params["appearance_embeddings"][train_image_id].detach()
        return torch.zeros_like(self.params["appearance_embeddings"][0]).detach()

    def get_train_embedding(self, index: int) -> Optional[np.ndarray]:
        e = self.get_embedding(index)
        return e.cpu().numpy() if e is not None else None

    @torch.no_grad()
    @full_f32()
    def render_pkg(self, camera: Cameras, *, options: Optional[Dict] = None) -> RenderPkg:
        """`render`'s device-side result on the padded canvas, before the
        clip and crop: the image tensors plus the render's counters and the
        blend kernel's inputs."""
        camera = camera.item()
        if int(camera.camera_models) != camera_model_to_int("pinhole"):
            raise ValueError("Only pinhole cameras are supported")
        render_depth = bool(options and "depth" in options.get("outputs", ()))
        w, h = int(camera.image_sizes[0]), int(camera.image_sizes[1])
        pw, ph = _round_up(w, 16), _round_up(h, 16)
        self._commit_store_to_mesh()
        np_embedding = (options or {}).get("embedding", None)
        embedding = (torch.as_tensor(np.asarray(np_embedding, np.float32), device=self.device)
                     if np_embedding is not None else self.get_embedding(None))
        with span("get_gaussians"):
            gaussians = gs.get_gaussians(self.params, self.aux)
        return render_internal(
            gaussians, self.params, self.mlp, self.aux.active_sh_degree,
            self.aux.alive, self.config,
            torch.as_tensor(np.asarray(camera.poses, np.float32), device=self.device),
            torch.as_tensor(np.asarray(camera.intrinsics, np.float32), device=self.device),
            pw, ph, embedding=embedding, kernel_size=self.config.kernel_size,
            render_depth=render_depth, actual_size=(float(w), float(h)))

    def render(self, camera: Cameras, *, options: Optional[Dict] = None, **kwargs) -> RenderOutput:
        del kwargs
        w, h = int(camera.item().image_sizes[0]), int(camera.item().image_sizes[1])
        pkg = self.render_pkg(camera, options=options)
        with span("to_host"):
            img = torch.nan_to_num(torch.clamp(pkg.render, 0.0, 1.0))
            out: RenderOutput = {
                "color": img[:h, :w].cpu().numpy(),
                "accumulation": pkg.accumulation[:h, :w].cpu().numpy(),
            }
            if pkg.depth is not None:
                out["depth"] = pkg.depth[:h, :w].cpu().numpy()
        return out

    # ---------------------------------------------------- embedding optimization

    def _embed_opt_inputs(self, dataset: Dataset):
        """The fixed inputs of `optimize_embedding`'s loss for the one image
        of `dataset`: (pose, intrinsics, (w, h), gt, pixel mask, loss
        multiplier or None), the images padded to the 16-pixel canvas."""
        camera = dataset["cameras"].item()
        if int(camera.camera_models) != camera_model_to_int("pinhole"):
            raise ValueError("Only pinhole cameras are supported")
        w, h = int(camera.image_sizes[0]), int(camera.image_sizes[1])
        pw, ph = _round_up(w, 16), _round_up(h, 16)

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=self.device)
        gt = dev(_pad_to(convert_image_dtype(dataset["images"][0], np.float32)[..., :3], ph, pw))
        pixmask = dev(_pad_to(np.ones((h, w, 1), np.float32), ph, pw)[..., 0])
        loss_mult = None
        if self.config.appearance_optim_type.endswith("-scaled"):
            unc = self._uncertainty_for_fits()
            if unc is not None:
                lm = unc.loss_mult_for_image(self.uparams, gt, pixmask, h, w)
                loss_mult = (lm > 1.0).to(torch.float32)
        if dataset.get("masks") is not None:
            m = dev(_pad_to(convert_image_dtype(dataset["masks"][0], np.float32)[..., None],
                            ph, pw)[..., 0])
            loss_mult = m if loss_mult is None else loss_mult * m
        return (dev(np.asarray(camera.poses, np.float32)),
                dev(np.asarray(camera.intrinsics, np.float32)), (float(w), float(h)),
                gt, pixmask, loss_mult)

    def _embed_opt_loss(self, gaussians, embedding, pose, intr, actual_size, gt, pixmask,
                        loss_mult):
        """The loss of one embedding-optimization step: the toned image only
        (return_raw=False) against `gt` over the pixel mask, with
        `loss_mult` scaling the gradients; returns (loss, mse)."""
        config = self.config
        pkg = render_internal(
            gaussians, self.params, self.mlp, self.aux.active_sh_degree, self.aux.alive,
            config, pose, intr, gt.shape[1], gt.shape[0], embedding=embedding,
            kernel_size=config.kernel_size, return_raw=False, actual_size=actual_size)
        image = pkg.render * pixmask[..., None]
        if loss_mult is not None:
            image = scale_grads(image, loss_mult[..., None])
        npix = torch.sum(pixmask)
        mse = torch.sum(torch.square(image - gt) * pixmask[..., None]) / (npix * 3)
        optim_type = config.appearance_optim_type
        if optim_type.endswith("-scaled"):
            optim_type = optim_type[:-len("-scaled")]
        if optim_type == "mse":
            loss = mse
        elif optim_type == "dssim+l1":
            l1 = torch.sum(torch.abs(image - gt) * pixmask[..., None]) / (npix * 3)
            ssim_v = torch.sum(ssim(image, gt, size_average=False) * pixmask) / npix
            loss = (1.0 - config.lambda_dssim) * l1 + config.lambda_dssim * (1.0 - ssim_v)
        else:
            raise ValueError(f"Unknown appearance optimization type {config.appearance_optim_type}")
        return loss, mse

    def _uncertainty_for_fits(self) -> Optional[UncertaintyModel]:
        """The uncertainty model for the "-scaled" fits, or None with
        `uncertainty_mode: disabled`; a model loaded from a checkpoint alone
        builds it (and its head, from the checkpoint) here, once."""
        if self._uncertainty is None and self._uncertainty_arrays is not None:
            self.uparams, bn = uncertainty_from_numpy(self._uncertainty_arrays, self.config,
                                                      self.device)
            self._uncertainty = UncertaintyModel(self.config, self.device)
            if bn is not None:
                self._uncertainty.bn_state = bn
            self._uncertainty_arrays = None
        return self._uncertainty

    @full_f32()
    def optimize_embedding(self, dataset: Dataset, *,
                           embedding: Optional[np.ndarray] = None) -> OptimizeEmbeddingOutput:
        """Fit an appearance embedding to the one image of `dataset` with the
        model fixed: `appearance_embedding_optim_iters` steps of Adam (b1
        0.9, b2 0.999, eps 1e-8, lr `appearance_embedding_optim_lr`), each
        on the gradient of the toned render's loss against the image
        (`appearance_optim_type`: "mse" or "dssim+l1", optionally
        "-scaled"), from `embedding` or zeros. Occluder masks in the dataset
        scale the gradients. Returns the embedding and each step's loss,
        mse and psnr."""
        if not self.config.appearance_enabled:
            raise NotImplementedError("Trying to optimize embedding with appearance_enabled=False")
        self._commit_store_to_mesh()
        inputs = self._embed_opt_inputs(dataset)
        emb = (torch.as_tensor(np.asarray(embedding, np.float32), device=self.device)
               if embedding is not None else self.get_embedding(None)).clone()
        mu, nu = torch.zeros_like(emb), torch.zeros_like(emb)
        lr = self.config.appearance_embedding_optim_lr
        # the step's constants in f32, as the JAX step forms them
        b1, b2, eps = (torch.tensor(x, dtype=torch.float32, device=self.device)
                       for x in (0.9, 0.999, 1e-8))
        with torch.no_grad():
            gaussians = gs.get_gaussians(self.params, self.aux)
        losses, mses = [], []
        for t in range(1, self.config.appearance_embedding_optim_iters + 1):
            var = emb.detach().requires_grad_(True)
            with span("embed_forward"):
                loss, mse = self._embed_opt_loss(gaussians, var, *inputs)
            with span("embed_backward"):
                (g,) = torch.autograd.grad(loss, [var])
                if self._store_mesh is not None:
                    all_reduce_(g, self._store_mesh)     # a sum over the Gaussians
            with torch.no_grad(), span("embed_adam"):
                mu = b1 * mu + (1 - b1) * g
                nu = b2 * nu + (1 - b2) * g * g
                mhat = mu / (1 - b1 ** t)
                nhat = nu / (1 - b2 ** t)
                emb = emb - lr * mhat / (torch.sqrt(nhat) + eps)
            losses.append(loss.detach())
            mses.append(mse.detach())
        # one host transfer for every step's values
        hist = (torch.stack([torch.stack(losses), torch.stack(mses)]).cpu().numpy()
                if losses else np.zeros((2, 0), np.float32))
        mse_list = [float(x) for x in hist[1]]
        return {
            "embedding": emb.cpu().numpy(),
            "metrics": {"psnr": [-10 * math.log10(max(x, 1e-10)) for x in mse_list],
                        "mse": mse_list, "loss": [float(x) for x in hist[0]]},
        }

    # ------------------------------------------------------------- checkpoints

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The training state as flat numpy arrays under the JAX package's
        `_state_dict` keys (what `chkpnt-<step>.npz` holds), of the whole
        store on a sharded one (every rank calls it)."""
        params, adam, aux = self._whole_store()
        return state_to_numpy(params, self.mlp, aux, adam, self.spatial_lr_scale,
                              self.uparams,
                              self._uncertainty.bn_state if self._uncertainty else None)

    def save(self, path: str):
        """Write `point_cloud.ply` (the live Gaussians: xyz, features_dc,
        the activated and filtered opacities and scales, rotations),
        `chkpnt-<step>.npz` (the JAX package's `_state_dict` keys: params,
        Adam moments and step, every aux buffer, spatial_lr_scale), its
        `.sha256` and `config.yaml`. The JAX package loads both."""
        if not hasattr(self, "adam"):
            raise RuntimeError("save needs a training state (construct with train_dataset)")
        os.makedirs(path, exist_ok=True)
        params, _adam, aux = self._whole_store()
        with torch.no_grad():
            gaussians = gs.get_gaussians(params, aux)
            alive = aux.alive

            def live(x):
                return x.detach()[alive].cpu().numpy()
            save_ply(os.path.join(path, "point_cloud.ply"),
                     xyz=live(params["xyz"]), features_dc=live(params["features_dc"]),
                     opacities=live(gaussians["opacities"]), scales=live(gaussians["scales"]),
                     rotations=live(params["rotations"]))
        state = self.state_dict()
        ckpt_path = os.path.join(path, f"chkpnt-{self.step}.npz")
        np.savez(ckpt_path, **state)
        with open(os.path.join(path, "config.yaml"), "w", encoding="utf8") as f:
            f.write(config_to_yaml(self.config))
        sha = hashlib.sha256()
        for k in sorted(state):
            sha.update(k.encode())
            sha.update(state[k].tobytes())
        with open(ckpt_path + ".sha256", "w", encoding="utf8") as f:
            f.write(sha.hexdigest())
