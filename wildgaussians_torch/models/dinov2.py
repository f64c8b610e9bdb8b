"""DINOv2 ViT backbone, frozen: the uncertainty model's feature extractor.

Counterpart of `wildgaussians_tpu/models/dinov2.py`: a patch-14 ViT with cls
and register tokens and LayerScale blocks, read as DINOv2's
`get_intermediate_layers` reads it (final LayerNorm applied, patch tokens
only) after block `num_heads - 1`. Weights come from the public torch
checkpoint (`dinov2_vits14_reg4_pretrain.pth`) where one is found locally
(`_find_weights`); otherwise from the JAX package's seeded random init,
draw for draw, with its warning. Nothing is downloaded.

The JAX package runs the ViT in XLA at `Precision.HIGHEST`, not in a Pallas
kernel, so here it is plain torch: the patch embedding (a convolution whose
stride is its kernel) is a reshape and a matmul, attention a matmul, a
softmax and a matmul, GELU the exact form; all f32, full f32 under
`device.full_f32`. `ARCHS`, `_WEIGHT_FILES`, `_random_params`,
`_convert_torch_state` and `_torch_bicubic_matrix` are copies of the JAX
package's (numpy, its parameter names).
"""
import logging
import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import LOCAL_CACHE, _is_url, _refuse_url

logger = logging.getLogger(__name__)

ARCHS = {
    "dinov2_vits14_reg": dict(embed_dim=384, depth=12, num_heads=6, mlp_ratio=4,
                              patch_size=14, num_register_tokens=4,
                              init_values=1.0),
    "dinov2_vitb14_reg": dict(embed_dim=768, depth=12, num_heads=12, mlp_ratio=4,
                              patch_size=14, num_register_tokens=4,
                              init_values=1.0),
    "dinov2_vits14": dict(embed_dim=384, depth=12, num_heads=6, mlp_ratio=4,
                          patch_size=14, num_register_tokens=0, init_values=1.0),
}

_WEIGHT_FILES = {
    "dinov2_vits14_reg": "dinov2_vits14_reg4_pretrain.pth",
    "dinov2_vitb14_reg": "dinov2_vitb14_reg4_pretrain.pth",
    "dinov2_vits14": "dinov2_vits14_pretrain.pth",
}


def _find_weights(backbone: str) -> Optional[str]:
    """The local checkpoint of `backbone`, or None: `WG_DINOV2_WEIGHTS` if it
    names an existing file (a URL raises), then the torch hub cache, then
    the port's cache directory."""
    env = os.environ.get("WG_DINOV2_WEIGHTS")
    candidates = []
    if env:
        if _is_url(env):
            _refuse_url(env)
        candidates.append(env)
    fname = _WEIGHT_FILES.get(backbone, f"{backbone}_pretrain.pth")
    candidates += [os.path.expanduser(f"~/.cache/torch/hub/checkpoints/{fname}"),
                   os.path.join(LOCAL_CACHE, fname)]
    return next((c for c in candidates if os.path.isfile(c)), None)


def _random_params(arch: dict, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    d = arch["embed_dim"]
    ps = arch["patch_size"]
    depth = arch["depth"]
    mlp = d * arch["mlp_ratio"]

    def tn(*shape, std=0.02):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    p = {
        "patch_w": tn(ps, ps, 3, d),
        "patch_b": np.zeros((d,), np.float32),
        "cls_token": tn(1, d, std=1e-6),
        "register_tokens": tn(max(arch["num_register_tokens"], 1), d, std=1e-6),
        "pos_embed_cls": tn(1, d),
        "pos_embed_patch": tn(37 * 37, d),  # 518/14 grid, interpolated later
        "norm_scale": np.ones((d,), np.float32),
        "norm_bias": np.zeros((d,), np.float32),
    }
    for i in range(depth):
        p[f"b{i}.norm1_scale"] = np.ones((d,), np.float32)
        p[f"b{i}.norm1_bias"] = np.zeros((d,), np.float32)
        p[f"b{i}.qkv_w"] = tn(d, 3 * d)
        p[f"b{i}.qkv_b"] = np.zeros((3 * d,), np.float32)
        p[f"b{i}.proj_w"] = tn(d, d)
        p[f"b{i}.proj_b"] = np.zeros((d,), np.float32)
        p[f"b{i}.ls1"] = np.full((d,), arch["init_values"], np.float32)
        p[f"b{i}.norm2_scale"] = np.ones((d,), np.float32)
        p[f"b{i}.norm2_bias"] = np.zeros((d,), np.float32)
        p[f"b{i}.fc1_w"] = tn(d, mlp)
        p[f"b{i}.fc1_b"] = np.zeros((mlp,), np.float32)
        p[f"b{i}.fc2_w"] = tn(mlp, d)
        p[f"b{i}.fc2_b"] = np.zeros((d,), np.float32)
        p[f"b{i}.ls2"] = np.full((d,), arch["init_values"], np.float32)
    return p


def _convert_torch_state(state: dict, arch: dict) -> Dict[str, np.ndarray]:
    """Map the public DINOv2 checkpoint names to our parameter dict."""
    def g(name):
        return np.asarray(state[name].float().numpy() if hasattr(state[name], "float")
                          else state[name], dtype=np.float32)

    d = arch["embed_dim"]
    p = {
        # torch conv [D,3,ps,ps] -> HWIO [ps,ps,3,D]
        "patch_w": g("patch_embed.proj.weight").transpose(2, 3, 1, 0),
        "patch_b": g("patch_embed.proj.bias"),
        "cls_token": g("cls_token").reshape(1, d),
        "pos_embed_cls": g("pos_embed")[0, :1],
        "pos_embed_patch": g("pos_embed")[0, 1:],
        "norm_scale": g("norm.weight"),
        "norm_bias": g("norm.bias"),
    }
    if arch["num_register_tokens"]:
        p["register_tokens"] = g("register_tokens").reshape(-1, d)
    else:
        p["register_tokens"] = np.zeros((1, d), np.float32)
    for i in range(arch["depth"]):
        pre = f"blocks.{i}."
        p[f"b{i}.norm1_scale"] = g(pre + "norm1.weight")
        p[f"b{i}.norm1_bias"] = g(pre + "norm1.bias")
        p[f"b{i}.qkv_w"] = g(pre + "attn.qkv.weight").T
        p[f"b{i}.qkv_b"] = g(pre + "attn.qkv.bias")
        p[f"b{i}.proj_w"] = g(pre + "attn.proj.weight").T
        p[f"b{i}.proj_b"] = g(pre + "attn.proj.bias")
        p[f"b{i}.ls1"] = g(pre + "ls1.gamma")
        p[f"b{i}.norm2_scale"] = g(pre + "norm2.weight")
        p[f"b{i}.norm2_bias"] = g(pre + "norm2.bias")
        p[f"b{i}.fc1_w"] = g(pre + "mlp.fc1.weight").T
        p[f"b{i}.fc1_b"] = g(pre + "mlp.fc1.bias")
        p[f"b{i}.fc2_w"] = g(pre + "mlp.fc2.weight").T
        p[f"b{i}.fc2_b"] = g(pre + "mlp.fc2.bias")
        p[f"b{i}.ls2"] = g(pre + "ls2.gamma")
    return p


def _torch_bicubic_matrix(m: int, out: int, offset: float) -> np.ndarray:
    """[out, m] interpolation matrix matching torch F.interpolate bicubic
    (align_corners=False, antialias=False, A=-0.75) driven by an explicit
    scale_factor (out + offset) / m, as DINOv2's pos-embed resize passes it."""
    A = -0.75

    def k(x):
        x = abs(x)
        if x <= 1.0:
            return ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0
        if x < 2.0:
            return (((x - 5.0) * x + 8.0) * x - 4.0) * A
        return 0.0

    scale = float(out + offset) / m
    W = np.zeros((out, m), np.float64)
    for j in range(out):
        x = (j + 0.5) / scale - 0.5
        x0 = math.floor(x)
        t = x - x0
        for dx in range(-1, 3):
            src = min(max(x0 + dx, 0), m - 1)
            W[j, src] += k(dx - t)
    return W.astype(np.float32)


def load_params(backbone: str):
    """(parameters, path): the backbone's parameters (numpy, the JAX
    package's names) from the local checkpoint `_find_weights` finds, or the
    seeded random init with a warning and path None."""
    arch = ARCHS[backbone]
    path = _find_weights(backbone)
    if path is None:
        logger.warning(
            "DINOv2 pretrained weights for %s not found (offline); using seeded random init. "
            "Set WG_DINOV2_WEIGHTS to the checkpoint path for reference-parity uncertainty.",
            backbone)
        return _random_params(arch), None
    logger.info("Loading DINOv2 weights from %s", path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    return _convert_torch_state(state, arch), path


class DinoV2(torch.nn.Module):
    """Frozen DINOv2 feature extractor on `device`: its parameters are
    buffers under the JAX package's names (a "." becomes "__")."""

    def __init__(self, backbone: str = "dinov2_vits14_reg", device="cpu",
                 params: Optional[Dict[str, np.ndarray]] = None):
        super().__init__()
        self.arch = ARCHS[backbone]
        self.backbone = backbone
        self.patch_size = self.arch["patch_size"]
        self.embed_dim = self.arch["embed_dim"]
        self.num_heads = self.arch["num_heads"]
        path = None
        if params is None:
            params, path = load_params(backbone)
        self.pretrained = path is not None
        for name, value in params.items():
            self.register_buffer(name.replace(".", "__"),
                                 torch.as_tensor(np.asarray(value, np.float32), device=device))
        self._pos_cache: Dict[tuple, torch.Tensor] = {}

    @classmethod
    def from_numpy(cls, params: Dict[str, np.ndarray], backbone: str = "dinov2_vits14_reg",
                   device="cpu") -> "DinoV2":
        """The module with `params` (numpy, the JAX package's names)."""
        return cls(backbone, device, params)

    def _p(self, name: str) -> torch.Tensor:
        return getattr(self, name.replace(".", "__"))

    def _interp_pos_embed(self, grid_h: int, grid_w: int) -> torch.Tensor:
        """The patch position embedding at a (grid_h, grid_w) grid: torch's
        bicubic resize of the 37x37 grid with DINOv2's +0.1 scale offset
        (`_torch_bicubic_matrix`), the grid itself when it is 37x37. Cached
        per grid (the weights are frozen)."""
        pe = self._p("pos_embed_patch")
        m = int(math.sqrt(pe.shape[0]))
        if (grid_h, grid_w) == (m, m):
            return pe
        out = self._pos_cache.get((grid_h, grid_w))
        if out is None:
            wy = torch.as_tensor(_torch_bicubic_matrix(m, grid_h, 0.1), device=pe.device)
            wx = torch.as_tensor(_torch_bicubic_matrix(m, grid_w, 0.1), device=pe.device)
            out = torch.einsum("hm,mnd,wn->hwd", wy, pe.reshape(m, m, -1), wx)
            out = out.reshape(grid_h * grid_w, -1)
            self._pos_cache[(grid_h, grid_w)] = out
        return out

    @torch.no_grad()
    def features(self, image: torch.Tensor, layer: Optional[int] = None) -> torch.Tensor:
        """image [H,W,3] normalised, H and W multiples of the patch size ->
        patch features [H/ps, W/ps, D] after block `layer` (default
        num_heads - 1) with the final LayerNorm applied."""
        ps = self.patch_size
        h, w = image.shape[0] // ps, image.shape[1] // ps
        layer = self.num_heads - 1 if layer is None else layer
        # the stride-ps convolution: each patch's (row, column, channel)
        # values against the HWIO kernel flattened in that order
        patches = image[:h * ps, :w * ps].reshape(h, ps, w, ps, 3).permute(0, 2, 1, 3, 4)
        x = patches.reshape(h * w, ps * ps * 3) @ self._p("patch_w").reshape(ps * ps * 3, -1)
        x = x + self._p("patch_b") + self._interp_pos_embed(h, w)
        tokens = [self._p("cls_token") + self._p("pos_embed_cls")]
        if self.arch["num_register_tokens"]:
            tokens.append(self._p("register_tokens"))
        x = torch.cat(tokens + [x], dim=0)
        for i in range(self.arch["depth"]):
            x = self._block(x, i)
            if i == layer:
                break
        x = self._layernorm(x, self._p("norm_scale"), self._p("norm_bias"))
        return x[1 + self.arch["num_register_tokens"]:].reshape(h, w, -1)

    @staticmethod
    def _layernorm(x, scale, bias, eps=1e-6):
        mu = x.mean(-1, keepdim=True)
        var = torch.square(x - mu).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * scale + bias

    def _block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        nh, d = self.num_heads, self.embed_dim
        hd = d // nh
        t = x.shape[0]

        def p(name):
            return self._p(f"b{i}.{name}")
        h = self._layernorm(x, p("norm1_scale"), p("norm1_bias"))
        qkv = h @ p("qkv_w") + p("qkv_b")
        q, k, v = (y.reshape(t, nh, hd).transpose(0, 1) for y in qkv.split(d, dim=-1))
        attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(hd), dim=-1)
        out = (attn @ v).transpose(0, 1).reshape(t, d)
        x = x + p("ls1") * (out @ p("proj_w") + p("proj_b"))
        h = self._layernorm(x, p("norm2_scale"), p("norm2_bias"))
        h = F.gelu(h @ p("fc1_w") + p("fc1_b"), approximate="none")
        return x + p("ls2") * (h @ p("fc2_w") + p("fc2_b"))
