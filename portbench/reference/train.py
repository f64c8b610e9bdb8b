"""The WildGaussians training step in plain PyTorch: the reference that the
benchmark holds the program's first steps against.

One step on one camera: the render (raw and, with appearance, toned
passes) on the canvas every training image is padded to, the uncertainty
model ("dino": the head on the true image's DINOv2 features, its loss, and
the thresholded per-pixel multiplier over the warm-up), L1 on the toned
image and DSSIM on the raw image weighted by the multiplier, autograd, and
Adam (eps 1e-15, bias-corrected, per-group learning rates with the
exponential position schedule). Imports nothing of the program.
"""
import math
from typing import Dict, List, NamedTuple, Optional

import torch

from . import dino
from . import render as R
from .image import content_mask, into_canvas, out_of_canvas, ssim_map

# the trained groups, keyed as the program's checkpoints key them
PER_GAUSSIAN = ("xyz", "features_dc", "features_rest", "scales", "rotations", "opacities",
                "embeddings")


class Inputs(NamedTuple):
    """Everything a step reads, as the benchmark made it."""
    state: Dict[str, torch.Tensor]       # live Gaussians' raw parameters, appearance_embeddings
    slots: torch.Tensor                  # [n] store slot of each live Gaussian
    mlp: Optional[Dict[str, torch.Tensor]]   # w0..b2, [in, out]
    head: Optional[Dict[str, torch.Tensor]]  # conv_w, conv_b, bn_scale, bn_bias
    bn: Optional[Dict[str, torch.Tensor]]    # running mean, var
    vit: Optional[Dict[str, torch.Tensor]]   # DINOv2 weights by public name
    mu: Dict[str, torch.Tensor]          # Adam's moments, keyed as `leaves`
    nu: Dict[str, torch.Tensor]
    adam_step: int
    spatial_lr_scale: float
    cams: List[R.Camera]                 # every training camera, on the canvas
    images: List[torch.Tensor]           # [h, w, 3] each, unpadded


def leaves(state, mlp, head) -> Dict[str, torch.Tensor]:
    """Every trained tensor, keyed as the program's checkpoints key them."""
    out = dict(state)
    for k, v in (mlp or {}).items():
        out["appearance_mlp/" + k] = v
    for k, v in (head or {}).items():
        out["uncertainty/" + k] = v
    return out


def learning_rate(cfg: dict, key: str, iteration: int, spatial: float) -> float:
    group = key.split("/")[0]
    if group == "xyz":
        t = min(max(iteration / cfg["position_lr_max_steps"], 0.0), 1.0)
        return math.exp(math.log(cfg["position_lr_init"] * spatial) * (1 - t)
                        + math.log(cfg["position_lr_final"] * spatial) * t)
    return {"features_dc": cfg["feature_lr"], "features_rest": cfg["feature_lr"] / 20.0,
            "opacities": cfg["opacity_lr"], "scales": cfg["scaling_lr"],
            "rotations": cfg["rotation_lr"],
            "appearance_embeddings": cfg["appearance_embedding_lr"],
            "embeddings": cfg["embedding_lr"], "appearance_mlp": cfg["appearance_mlp_lr"],
            "uncertainty": cfg["uncertainty_lr"]}[group]


def warmup_fraction(cfg: dict, iteration: int) -> float:
    start, iters = cfg["uncertainty_warmup_start"], cfg["uncertainty_warmup_iters"]
    if iteration < start:
        return 0.0
    return 1.0 if iters <= 0 else min(max((iteration - start) / iters, 0.0), 1.0)


def protected(cfg: dict, iteration: int) -> bool:
    """Within `uncertainty_protected_iters` after the last opacity reset."""
    last = min(iteration, cfg["densify_until_iter"] - 1)
    reset = (last // cfg["opacity_reset_interval"]) * cfg["opacity_reset_interval"]
    return iteration < reset + cfg["uncertainty_protected_iters"]


def step_loss(inp: Inputs, cfg: dict, state, mlp, head, bn, cam_id: int, iteration: int,
              filt, keep: Optional[torch.Tensor], canvas, pixel_share: float = 1.0):
    """(loss, new running statistics) of one step. `pixel_share` < 1 keeps
    only that leading share of the image's rows (a fault the check must
    catch)."""
    cam = inp.cams[cam_id]
    ah, aw = int(cam.actual_h), int(cam.actual_w)
    W, H = canvas
    frame = R.render(state, mlp, filt, inp.slots, cam, cfg,
                     state["appearance_embeddings"][cam_id] if cfg["appearance_enabled"] else None)
    dev = frame.toned.device
    pix = torch.zeros((H, W), device=dev)
    pix[:max(1, int(round(ah * pixel_share))), :aw] = 1.0
    gt = torch.zeros((H, W, 3), device=dev)
    gt[:ah, :aw] = inp.images[cam_id]
    toned = frame.toned * pix[..., None]
    raw = frame.raw * pix[..., None]
    weight, uloss, new_bn = pix, 0.0, bn
    if cfg["uncertainty_mode"] != "disabled":
        gt336 = into_canvas(gt, dino.CANVAS, ah, aw)
        mask336 = content_mask(dino.CANVAS, ah, aw, 1, dev)
        pmask = content_mask(dino.CANVAS, ah, aw, dino.PATCH, dev)
        heads = inp.vit["blocks.0.attn.qkv.weight"].shape[1] // 64
        with torch.no_grad():
            f_true = dino.features(inp.vit, gt336, heads, heads - 1)
            f_pred = dino.features(inp.vit, into_canvas(toned.detach(), dino.CANVAS, ah, aw),
                                   heads, heads - 1)
        u, new_bn = dino.head(head, bn, f_true, keep, cfg["uncertainty_dropout"], pmask,
                              cfg["uncertainty_clip_min"])
        uloss, mult336 = dino.loss(u, f_true, f_pred, mask336,
                                   cfg["uncertainty_regularizer_weight"])
        with torch.no_grad():
            lm = (out_of_canvas(mult336[..., None], H, W, ah, aw)[..., 0] * pix > 1.0).float()
            mult = 1.0 + warmup_fraction(cfg, iteration) * (lm - 1.0)
        if protected(cfg, iteration):
            uloss = uloss.detach()
        weight = mult * pix
    npix = pix.sum()
    l1 = ((toned - gt).abs() * weight[..., None]).sum() / (npix * 3)
    dssim = ((1.0 - ssim_map(raw, gt)) * weight).sum() / npix
    lam = cfg["lambda_dssim"]
    return (1 - lam) * l1 + lam * dssim + uloss, new_bn


def run_steps(inp: Inputs, cfg: dict, cam_ids: List[int], first_iteration: int, canvas,
              pixel_share: float = 1.0):
    """Follow the program's first len(cam_ids) steps from `inp`. Returns
    (losses, step 1's gradients, the parameters after the last step), each
    per leaf."""
    dev = inp.state["xyz"].device
    filt = R.filter_3d(inp.state["xyz"], inp.cams)
    state = {k: v.clone().requires_grad_(True) for k, v in inp.state.items()}
    mlp = {k: v.clone().requires_grad_(True) for k, v in (inp.mlp or {}).items()} or None
    head = {k: v.clone().requires_grad_(True) for k, v in (inp.head or {}).items()} or None
    bn = inp.bn
    mu = {k: v.clone() for k, v in inp.mu.items()}
    nu = {k: v.clone() for k, v in inp.nu.items()}
    gen = torch.Generator(device=dev).manual_seed(int(cfg["seed"]))
    losses, first_grads = [], None
    for i, cam_id in enumerate(cam_ids):
        iteration = first_iteration + i
        keep = None
        if cfg["uncertainty_mode"] != "disabled" and cfg["uncertainty_dropout"] > 0:
            d = inp.vit["norm.weight"].shape[0]
            keep = torch.bernoulli(torch.full((1, 1, d), 1 - cfg["uncertainty_dropout"],
                                              device=dev), generator=gen)
        loss, bn = step_loss(inp, cfg, state, mlp, head, bn, cam_id, iteration, filt, keep,
                             canvas, pixel_share)
        params = leaves(state, mlp, head)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        t = inp.adam_step + i + 1
        bc1, bc2 = 1 - 0.9 ** t, 1 - 0.999 ** t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                mu[k] = 0.9 * mu[k] + 0.1 * g
                nu[k] = 0.999 * nu[k] + 0.001 * g * g
                lr = learning_rate(cfg, k, iteration, inp.spatial_lr_scale)
                p -= lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + 1e-15)
        del loss, grads
    final = {k: v.detach() for k, v in leaves(state, mlp, head).items()}
    return losses, first_grads, final


@torch.no_grad()
def serve_image(inp: Inputs, cfg: dict, cam: R.Camera, embedding: Optional[torch.Tensor],
                filt: torch.Tensor) -> torch.Tensor:
    """The image a viewer gets: the toned render clipped to [0, 1], [h, w, 3],
    under the checkpoint's 3D filter `filt` [n, 1]."""
    frame = R.render(inp.state, inp.mlp, filt, inp.slots, cam, cfg, embedding)
    img = torch.nan_to_num(torch.clamp(frame.toned, 0.0, 1.0))
    return img[:int(cam.actual_h), :int(cam.actual_w)]
