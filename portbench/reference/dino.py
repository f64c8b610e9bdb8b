"""DINOv2 ViT-S/14 with four registers, and the WildGaussians uncertainty
head and loss, in plain PyTorch for the reference.

The ViT follows the published DINOv2 code: a stride-14 convolution, cls
and register tokens, the 37x37 position grid resized bicubically with the
+0.1 offset, pre-norm blocks with LayerScale, exact GELU, LayerNorm eps
1e-6. The features are the patch tokens after block `layer` with the final
norm, as `get_intermediate_layers` returns them. Weights use the public
checkpoint's names.

The head (WildGaussians, "dino" mode): channel dropout, a batch norm whose
statistics come from the patches inside the letterboxed content (biased
variance, eps 1e-5, running statistics moved by 0.1), a 1x1 convolution
plus softplus^-1(1), softplus, a linear resize to 336, clipped below. The
loss weights each pixel by 1 / (2 u^2) times the DINO dissimilarity of the
rendered and true images, plus `regularizer` times mean log u.
"""
import math
from typing import Dict

import torch
import torch.nn.functional as F

from .image import resize

CANVAS = 336
PATCH = 14
MEAN = (123.675 / 255.0, 116.28 / 255.0, 103.53 / 255.0)
STD = (58.395 / 255.0, 57.12 / 255.0, 57.375 / 255.0)
PRIOR = math.log(math.e - 1.0)


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps=1e-6)


def features(w: Dict[str, torch.Tensor], img: torch.Tensor, heads: int, layer: int) -> torch.Tensor:
    """img [336, 336, 3] in [0, 1] -> patch features [24, 24, D]."""
    mean = torch.tensor(MEAN, device=img.device)
    std = torch.tensor(STD, device=img.device)
    x = ((img - mean) / std).permute(2, 0, 1)[None]
    x = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"], stride=PATCH)
    gh, gw = x.shape[2], x.shape[3]
    x = x.flatten(2).transpose(1, 2)[0]
    d = x.shape[-1]
    pos = w["pos_embed"][0]
    m = int(math.sqrt(pos.shape[0] - 1))
    grid = pos[1:].reshape(1, m, m, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + 0.1) / m, (gw + 0.1) / m), mode="bicubic",
                         antialias=False)
    x = x + grid[0].permute(1, 2, 0).reshape(gh * gw, d)
    cls = w["cls_token"][0] + pos[:1]
    regs = w["register_tokens"][0]
    x = torch.cat([cls, regs, x], 0)
    hd = d // heads
    for i in range(layer + 1):
        p = f"blocks.{i}."
        h = _ln(x, w[p + "norm1.weight"], w[p + "norm1.bias"])
        qkv = (h @ w[p + "attn.qkv.weight"].T + w[p + "attn.qkv.bias"]).reshape(-1, 3, heads, hd)
        q, k, v = qkv.permute(1, 2, 0, 3)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(hd), -1)
        o = (att @ v).transpose(0, 1).reshape(-1, d)
        x = x + w[p + "ls1.gamma"] * (o @ w[p + "attn.proj.weight"].T + w[p + "attn.proj.bias"])
        h = _ln(x, w[p + "norm2.weight"], w[p + "norm2.bias"])
        h = F.gelu(h @ w[p + "mlp.fc1.weight"].T + w[p + "mlp.fc1.bias"])
        x = x + w[p + "ls2.gamma"] * (h @ w[p + "mlp.fc2.weight"].T + w[p + "mlp.fc2.bias"])
    x = _ln(x, w["norm.weight"], w["norm.bias"])
    return x[1 + regs.shape[0]:].reshape(gh, gw, d)


def head(hp: Dict[str, torch.Tensor], bn: Dict[str, torch.Tensor], feats: torch.Tensor,
         keep: torch.Tensor, dropout: float, patch_mask: torch.Tensor, clip_min: float):
    """(u [336, 336], new running statistics) in training mode; `keep`
    [1, 1, D] is the dropout's 0/1 channel mask."""
    x = feats * keep / (1 - dropout) if dropout > 0 else feats
    pm = patch_mask[..., None]
    n = torch.clamp_min(pm.sum(), 1.0)
    mu = (x * pm).sum((0, 1)) / n
    var = (((x - mu) ** 2) * pm).sum((0, 1)) / n
    new_bn = {"mean": 0.9 * bn["mean"] + 0.1 * mu.detach(),
              "var": 0.9 * bn["var"] + 0.1 * var.detach()}
    x = (x - mu) / torch.sqrt(var + 1e-5) * hp["bn_scale"] + hp["bn_bias"]
    logits = x @ hp["conv_w"] + hp["conv_b"] + PRIOR
    u = resize(F.softplus(logits), (CANVAS, CANVAS))
    return torch.clamp_min(u, clip_min)[..., 0], new_bn


def loss(u: torch.Tensor, f_true: torch.Tensor, f_pred: torch.Tensor, mask: torch.Tensor,
         regularizer: float):
    """(loss, the per-pixel loss multiplier at 336, capped at 3)."""
    mult = 1.0 / (2 * u * u)
    with torch.no_grad():
        cos = (f_true * f_pred).sum(-1) / torch.clamp_min(f_true.norm(dim=-1) * f_pred.norm(dim=-1),
                                                         1e-12)
        dissim = torch.clamp(1.0 - (resize(cos[..., None], (CANVAS, CANVAS))[..., 0] - 0.5) / 0.5,
                             0.0, 1.0)
    n = torch.clamp_min(mask.sum(), 1.0)
    total = (dissim * mult * mask).sum() / n + regularizer * (torch.log(u) * mask).sum() / n
    return total, torch.clamp_max(mult, 3.0).detach()
