"""DINOv2-based uncertainty (occlusion) model.

Counterpart of `wildgaussians_tpu/models/uncertainty.py`: the frozen DINOv2
backbone, a head of channel dropout, batch norm and a 1x1 convolution with a
softplus(+1) prior, and the dino, dino+mssim, l2reg and l1reg losses that
produce the per-pixel `loss_mult` that down-weights transient occluders.

As in the JAX package, all of it runs at one size, DINO_SIZE x DINO_SIZE (a
multiple of the 14-pixel patch): an image's valid region is resized into
that canvas (`resize_valid`, letterboxed with one scale for both axes by
default) and the map back (`resize_to_valid`), from the padded image, with
the resize of `ops/image.py` over the whole padded axis. The ground truth's
DINO features are cached per camera on the device; the prediction's are
computed each step.

The batch norm is written out, as in the JAX package: its statistics are
taken over the letterbox-valid patches only (`patch_mask`), the variance is
the biased one, the running statistics move by momentum 0.1 towards the
batch's, and eps is 1e-5 (`nn.BatchNorm2d` keeps an unbiased running
variance and takes no mask). Dropout comes first and keeps whole channels:
a [1, 1, D] mask scaled by 1 / (1 - p), drawn from the caller's
`torch.Generator` or passed in (`keep`).
"""
import logging
import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..ops.image import resize, scale_and_translate
from ..ops.ssim import msssim, ssim_down
from ..spans import span
from ..utils import LOCAL_CACHE, _is_url
from .dinov2 import DinoV2

logger = logging.getLogger(__name__)

DINO_SIZE = 336  # multiple of 14; 24x24 patch grid
IMG_NORM_MEAN = np.array([123.675, 116.28, 103.53], np.float32) / 255.0
IMG_NORM_STD = np.array([58.395, 57.12, 57.375], np.float32) / 255.0
SOFTPLUS_PRIOR = math.log(math.exp(1.0) - 1.0)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _letterbox_scale(out_h: int, out_w: int, valid_h, valid_w, letterbox: bool):
    """(scale_h, scale_w) valid region -> canvas as np.float32, each an f32
    division on the host (as the JAX package forms them from f32 valid
    sizes); with `letterbox` both the smaller one (aspect kept), else each
    axis its own (squashed)."""
    sh = np.float32(out_h) / np.float32(valid_h)
    sw = np.float32(out_w) / np.float32(valid_w)
    return (min(sh, sw),) * 2 if letterbox else (sh, sw)


def resize_valid(img: torch.Tensor, out_h: int, out_w: int, valid_h, valid_w,
                 letterbox: bool = False) -> torch.Tensor:
    """The [0:valid_h, 0:valid_w] region of `img` ([H,W] or [H,W,C]) resized
    into an (out_h, out_w) canvas (antialiased linear); with `letterbox` the
    content occupies [0, valid_h s) x [0, valid_w s) (see content_mask)."""
    x = img if img.dim() == 3 else img[..., None]
    scale = _letterbox_scale(out_h, out_w, valid_h, valid_w, letterbox)
    out = scale_and_translate(x, (out_h, out_w, x.shape[-1]), (0, 1), scale, (0.0, 0.0),
                              antialias=True)
    return out if img.dim() == 3 else out[..., 0]


def content_mask(out_h: int, out_w: int, valid_h, valid_w, letterbox: bool,
                 granularity: int = 1, device="cpu") -> torch.Tensor:
    """[out_h/g, out_w/g] 0/1 mask of the letterboxed content (all ones when
    squashed); granularity = the patch size gives the patch-level mask."""
    g = granularity
    scale = _letterbox_scale(out_h, out_w, valid_h, valid_w, letterbox)
    ch = float(np.float32(valid_h) * scale[0])
    cw = float(np.float32(valid_w) * scale[1])
    yy = (torch.arange(out_h // g, dtype=torch.float32, device=device) + 0.5) * g
    xx = (torch.arange(out_w // g, dtype=torch.float32, device=device) + 0.5) * g
    return ((yy[:, None] <= ch) & (xx[None, :] <= cw)).to(torch.float32)


def resize_to_valid(img: torch.Tensor, out_h: int, out_w: int, valid_h, valid_w,
                    letterbox: bool = False) -> torch.Tensor:
    """The inverse of resize_valid: the canvas content mapped back onto the
    [0:valid_h, 0:valid_w] region of an (out_h, out_w) canvas (bilinear)."""
    x = img if img.dim() == 3 else img[..., None]
    fwd = _letterbox_scale(x.shape[0], x.shape[1], valid_h, valid_w, letterbox)
    scale = [np.float32(1.0) / s for s in fwd]
    out = scale_and_translate(x, (out_h, out_w, x.shape[-1]), (0, 1), scale, (0.0, 0.0),
                              antialias=False)
    return out if img.dim() == 3 else out[..., 0]


class UncertaintyModel:
    """The uncertainty model of `config` on `device`: the backbone, its
    running batch-norm statistics (`bn_state`) and the per-camera feature
    cache; the head's parameters are the caller's (`init_params`)."""

    def __init__(self, config: Config, device="cpu"):
        self.config = config
        self.device = torch.device(device)
        self.dino = DinoV2(config.uncertainty_backbone, device=self.device)
        d = self.dino.embed_dim
        self.bn_state = {"mean": torch.zeros((d,), device=self.device),
                         "var": torch.ones((d,), device=self.device)}
        self._cache: Dict[int, torch.Tensor] = {}
        self._norm = (_f32(IMG_NORM_MEAN, self.device), _f32(IMG_NORM_STD, self.device))

    # ------------------------------------------------------------------ setup

    def init_params(self, rng: np.random.Generator) -> Dict[str, torch.Tensor]:
        """The head's parameters: conv_w ~ N(0, 0.01) [D, 1] from `rng`, zero
        conv_b, unit bn_scale, zero bn_bias. When WG_ADE20K_HEAD names a local
        copy of the DINOv2 ADE20k linear-head checkpoint ("auto" or a URL: the
        file of that name in the local cache, if there), the head and the
        batch-norm statistics are seeded from it
        (`initialize_head_from_ade20k`). Nothing is downloaded."""
        d = self.dino.embed_dim
        params = {
            "conv_w": _f32(rng.normal(0, 0.01, (d, 1)).astype(np.float32), self.device),
            "conv_b": torch.zeros((1,), device=self.device),
            "bn_scale": torch.ones((d,), device=self.device),
            "bn_bias": torch.zeros((d,), device=self.device),
        }
        path = os.environ.get("WG_ADE20K_HEAD")
        if path:
            if path == "auto":
                path = os.path.join(LOCAL_CACHE, f"{self.dino.backbone}_ade20k_linear_head.pth")
            elif _is_url(path):
                path = os.path.join(LOCAL_CACHE, path.rsplit("/", 1)[-1])
            if os.path.isfile(path):
                params = self.initialize_head_from_ade20k(params, path)
            else:
                logger.warning("WG_ADE20K_HEAD: no local file %s; the head keeps its random "
                               "init", path)
        return params

    def initialize_head_from_ade20k(self, params: Dict[str, torch.Tensor], path: str
                                    ) -> Dict[str, torch.Tensor]:
        """The JAX package's reading of the DINOv2 ADE20k linear head: conv_w
        is an N(0, 1e-4) base (seed 0) plus 1000 times the sum of the
        sky/water/plant/person class rows, conv_b zero, and the head's
        batch-norm affine and running statistics where it has them."""
        cls_to_ignore = [13, 21, 81, 84]
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        state = ckpt.get("state_dict", ckpt)
        old_w = np.asarray(state["decode_head.conv_seg.weight"].float())
        d = self.dino.embed_dim
        base = np.random.default_rng(0).normal(0, 1e-4, (d,)).astype(np.float32)
        boost = old_w[cls_to_ignore, :d, 0, 0].sum(axis=0) * 1000.0
        params = dict(params)
        params["conv_w"] = _f32((base + boost)[:, None], self.device)
        params["conv_b"] = torch.zeros((1,), device=self.device)
        if state.get("decode_head.bn.weight") is not None:
            def t(key):
                return _f32(np.asarray(state[key].float()), self.device)
            params["bn_scale"] = t("decode_head.bn.weight")
            params["bn_bias"] = t("decode_head.bn.bias")
            self.bn_state = {"mean": t("decode_head.bn.running_mean"),
                             "var": t("decode_head.bn.running_var")}
        logger.info("Uncertainty head seeded from ADE20k checkpoint %s", path)
        return params

    # ------------------------------------------------------------- primitives

    def dino_features(self, img336: torch.Tensor) -> torch.Tensor:
        """[336,336,3] in [0,1] -> frozen patch features [24,24,D]."""
        mean, std = self._norm
        return self.dino.features((img336 - mean) / std)

    def gt_features(self, camera_id: int, gt336: torch.Tensor) -> torch.Tensor:
        """The ground truth's features of a camera, computed on its first
        visit (span `dino_gt`) and kept on the device."""
        feats = self._cache.get(camera_id)
        if feats is None:
            with span("dino_gt"):
                feats = self.dino_features(gt336)
            self._cache[camera_id] = feats
        return feats

    def head_uncertainty(self, uparams: Dict[str, torch.Tensor], bn_state, feats: torch.Tensor,
                         *, train: bool, keep: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None, momentum: float = 0.1,
                         patch_mask: Optional[torch.Tensor] = None):
        """Dropout -> batch norm -> 1x1 conv -> + prior -> softplus -> resize
        to DINO_SIZE -> clip below at `uncertainty_clip_min`. feats [h,w,D];
        in train mode with dropout, `keep` ([1,1,D] 0/1) or a draw from
        `generator`; `patch_mask` [h,w] restricts the batch statistics.
        Returns (u [DINO_SIZE, DINO_SIZE], new bn_state)."""
        cfg = self.config
        x = feats
        p = cfg.uncertainty_dropout
        if train and p > 0:
            if keep is None:
                keep = torch.bernoulli(torch.full((1, 1, x.shape[-1]), 1 - p, device=x.device),
                                       generator=generator)
            x = x * keep / (1 - p)
        if patch_mask is None:
            patch_mask = torch.ones(x.shape[:2], device=x.device)
        pm = patch_mask[..., None]
        psum = torch.clamp_min(torch.sum(pm), 1.0)
        if train:
            mu = torch.sum(x * pm, dim=(0, 1)) / psum
            var = torch.sum(torch.square(x - mu) * pm, dim=(0, 1)) / psum
            new_bn = {"mean": (1 - momentum) * bn_state["mean"] + momentum * mu.detach(),
                      "var": (1 - momentum) * bn_state["var"] + momentum * var.detach()}
        else:
            mu, var = bn_state["mean"], bn_state["var"]
            new_bn = bn_state
        x = (x - mu) * torch.rsqrt(var + 1e-5)
        x = x * uparams["bn_scale"] + uparams["bn_bias"]
        logits = x @ uparams["conv_w"] + uparams["conv_b"] + SOFTPLUS_PRIOR   # [h,w,1]
        u = resize(F.softplus(logits), (DINO_SIZE, DINO_SIZE, 1))
        return torch.clamp_min(u, cfg.uncertainty_clip_min)[..., 0], new_bn

    @staticmethod
    def _cosine_map(fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
        """Per-patch cosine similarity of two [h,w,D] feature maps, resized
        to DINO_SIZE."""
        num = torch.sum(fx * fy, -1)
        den = torch.linalg.vector_norm(fx, dim=-1) * torch.linalg.vector_norm(fy, dim=-1)
        return resize(num / torch.clamp_min(den, 1e-12), (DINO_SIZE, DINO_SIZE))

    # ------------------------------------------------------------------ losses

    def compute_loss(self, uparams, bn_state, feats_gt, gt336, pred336, mask336, *,
                     train: bool, keep=None, generator=None, patch_mask=None):
        """(loss, metrics, loss_mult336, new bn_state). Every spatial mean is
        masked by `mask336` (the letterbox mask), the batch statistics by
        `patch_mask`; loss_mult336 carries no gradient."""
        cfg = self.config
        mode = cfg.uncertainty_mode
        if mode not in ("l2reg", "l1reg", "dino", "dino+mssim"):
            raise ValueError(f"Invalid uncertainty_mode: {mode}")
        with span("uncertainty_head"):
            u, new_bn = self.head_uncertainty(uparams, bn_state, feats_gt, train=train, keep=keep,
                                              generator=generator, patch_mask=patch_mask)
        if mode.startswith("dino"):
            with span("dino_pred"):
                feats_pred = self.dino_features(pred336)
        with span("uncertainty_loss"):
            log_u = torch.log(u)
            one = torch.ones_like(u)      # a true division (torch's 1.0 / t multiplies)
            msk = mask336
            msum = torch.clamp_min(torch.sum(msk), 1.0)

            def mmean(x):
                return torch.sum(x * msk) / msum

            with torch.no_grad():
                _msssim = msssim(gt336, pred336, max_size=None, min_size=80)
            if mode in ("l2reg", "l1reg"):
                loss_mult = (one / (2 * torch.square(u)) if mode == "l2reg" else one / u)
                uncertainty_loss = (1 - _msssim) * loss_mult
                loss_mult_out = loss_mult
            else:
                loss_mult = one / (2 * torch.square(u))
                with torch.no_grad():
                    dino_cos = self._cosine_map(feats_gt, feats_pred)
                    dino_part = torch.clamp(1.0 - (dino_cos - 0.5) / 0.5, 0.0, 1.0)
                    if mode == "dino+mssim":
                        dino_part = torch.minimum(dino_part, 1 - _msssim)
                uncertainty_loss = dino_part * loss_mult
                loss_mult_out = torch.clamp_max(loss_mult, 3.0)
            beta = mmean(log_u)
            loss = mmean(uncertainty_loss) + cfg.uncertainty_regularizer_weight * beta
            with torch.no_grad():
                loss_mult_out = loss_mult_out.detach()
                _ssim = ssim_down(gt336, pred336, max_size=400)
                lsum = torch.clamp_min(torch.sum(loss_mult_out * msk), 1e-12)
                mse_disc = torch.sum(torch.square(gt336 - pred336).mean(-1) * loss_mult_out
                                     * msk) / lsum
                metrics = {
                    "uncertainty_loss": loss.detach(),
                    "msssim": mmean(_msssim),
                    "ssim_discounted": torch.sum(_ssim * loss_mult_out * msk) / lsum,
                    "mse_discounted": mse_disc,
                    "psnr_discounted": -10 * torch.log10(torch.clamp_min(mse_disc, 1e-10)),
                    "beta": beta.detach(),
                }
        return loss, metrics, loss_mult_out, new_bn

    # ------------------------------------------------------- eval-time helper

    @torch.no_grad()
    def loss_mult_for_image(self, uparams, gt_padded: torch.Tensor, pixmask: torch.Tensor,
                            valid_h, valid_w) -> torch.Tensor:
        """loss_mult of an image against itself (eval mode, the running
        batch-norm statistics), on its padded canvas times `pixmask`: what
        `optimize_embedding`'s "-scaled" modes threshold at 1."""
        lb = self.config.uncertainty_dino_letterbox
        dev = gt_padded.device
        gt336 = resize_valid(gt_padded, DINO_SIZE, DINO_SIZE, valid_h, valid_w, letterbox=lb)
        feats = self.dino_features(gt336)
        _loss, _metrics, lm336, _bn = self.compute_loss(
            uparams, self.bn_state, feats, gt336, gt336,
            content_mask(DINO_SIZE, DINO_SIZE, valid_h, valid_w, lb, device=dev), train=False,
            patch_mask=content_mask(DINO_SIZE, DINO_SIZE, valid_h, valid_w, lb,
                                    granularity=self.dino.patch_size, device=dev))
        h, w = gt_padded.shape[:2]
        return resize_to_valid(lm336, h, w, valid_h, valid_w, letterbox=lb) * pixmask
