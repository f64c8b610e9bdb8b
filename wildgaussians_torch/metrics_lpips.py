"""LPIPS perceptual metric, a self-contained plain-torch implementation.

The port's copy of `wildgaussians_tpu/metrics_lpips.py`: AlexNet or VGG16
trunks and the LPIPS 1x1 linear heads. Nothing is downloaded; the weights
come from local files only:

  - WG_LPIPS_WEIGHTS_DIR (or ~/.cache/wild-gaussians-tpu/lpips/, or the
    torch hub checkpoint cache) containing alexnet-owt-7be5be79.pth /
    vgg16-397923af.pth (torchvision state dicts) and lpips_{net}_{version}.pth
    (the LPIPS linear heads)

Without them, construction raises FileNotFoundError and
evaluation.compute_metrics reports NaN for lpips (see evaluation._lpips).
"""
import os
from typing import List

import torch
import torch.nn as nn

_WEIGHT_DIRS = [
    os.environ.get("WG_LPIPS_WEIGHTS_DIR", ""),
    os.path.expanduser("~/.cache/wild-gaussians-tpu/lpips"),
    os.path.expanduser("~/.cache/torch/hub/checkpoints"),
]


def _find(fname: str) -> str:
    for d in _WEIGHT_DIRS:
        if d and os.path.exists(os.path.join(d, fname)):
            return os.path.join(d, fname)
    raise FileNotFoundError(
        f"LPIPS weight file {fname} not found in {_WEIGHT_DIRS}; "
        "set WG_LPIPS_WEIGHTS_DIR (offline environment)")


class _AlexFeatures(nn.Module):
    """torchvision AlexNet.features, split at the LPIPS tap points."""

    def __init__(self):
        super().__init__()
        cfg = [
            (nn.Conv2d(3, 64, 11, 4, 2), True),
            (nn.MaxPool2d(3, 2), False),
            (nn.Conv2d(64, 192, 5, 1, 2), True),
            (nn.MaxPool2d(3, 2), False),
            (nn.Conv2d(192, 384, 3, 1, 1), True),
            (nn.Conv2d(384, 256, 3, 1, 1), True),
            (nn.Conv2d(256, 256, 3, 1, 1), True),
        ]
        layers: List[nn.Module] = []
        for mod, relu in cfg:
            layers.append(mod)
            if relu:
                layers.append(nn.ReLU(inplace=True))
        self.features = nn.Sequential(*layers)
        # taps after each ReLU (indices in self.features)
        self.taps = [1, 4, 7, 9, 11]
        self.n_channels = [64, 192, 384, 256, 256]
        state = torch.load(_find("alexnet-owt-7be5be79.pth"), map_location="cpu",
                           weights_only=True)
        own = {}
        conv_ids = [0, 3, 6, 8, 10]
        src_ids = [0, 3, 6, 8, 10]
        for dst, src in zip(conv_ids, src_ids):
            own[f"features.{dst}.weight"] = state[f"features.{src}.weight"]
            own[f"features.{dst}.bias"] = state[f"features.{src}.bias"]
        self.load_state_dict(own, strict=False)

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                outs.append(x)
        return outs


class _VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512]
        layers: List[nn.Module] = []
        in_ch = 3
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.Conv2d(in_ch, v, 3, padding=1))
                layers.append(nn.ReLU(inplace=True))
                in_ch = v
        self.features = nn.Sequential(*layers)
        self.taps = [3, 8, 15, 22, 29]  # relu1_2, 2_2, 3_3, 4_3, 5_3
        self.n_channels = [64, 128, 256, 512, 512]
        state = torch.load(_find("vgg16-397923af.pth"), map_location="cpu",
                           weights_only=True)
        own = {k: v for k, v in state.items() if k.startswith("features.")}
        self.load_state_dict(own, strict=False)

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                outs.append(x)
        return outs


def _normalize_tensor(x, eps=1e-10):
    norm = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    """Perceptual distance: inputs in [-1, 1], NCHW. Reference
    _metrics_lpips.py:50-210 behavior (spatial=False, mean over taps)."""

    def __init__(self, net: str = "alex", version: str = "0.1"):
        super().__init__()
        self.version = version
        self.register_buffer("shift", torch.tensor([-.030, -.088, -.188])[None, :, None, None])
        self.register_buffer("scale", torch.tensor([.458, .448, .450])[None, :, None, None])
        if net == "alex":
            self.net = _AlexFeatures()
        elif net == "vgg":
            self.net = _VGG16Features()
        else:
            raise ValueError(f"Unsupported LPIPS net {net}")
        self.lins = nn.ModuleList([
            nn.Conv2d(c, 1, 1, bias=False) for c in self.net.n_channels])
        heads = torch.load(_find(f"lpips_{net}_{version}.pth"), map_location="cpu",
                           weights_only=True)
        # official lpips naming: lin{i}.model.1.weight
        own = {}
        for i in range(len(self.lins)):
            for cand in (f"lin{i}.model.1.weight", f"lins.{i}.weight"):
                if cand in heads:
                    own[f"lins.{i}.weight"] = heads[cand]
                    break
        self.load_state_dict(own, strict=False)
        self.eval()
        for p in self.parameters():
            p.requires_grad = False

    def forward(self, in0, in1):
        x0 = (in0 - self.shift) / self.scale
        x1 = (in1 - self.shift) / self.scale
        f0 = self.net(x0)
        f1 = self.net(x1)
        total = 0
        for feat0, feat1, lin in zip(f0, f1, self.lins):
            d = (_normalize_tensor(feat0) - _normalize_tensor(feat1)) ** 2
            total = total + lin(d).mean(dim=(2, 3), keepdim=False)
        return total.squeeze(1)
