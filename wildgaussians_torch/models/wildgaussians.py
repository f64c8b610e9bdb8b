"""WildGaussians, serving path: load a checkpoint, take a camera, return an
image.

Counterpart of the checkpoint loading, `get_embedding`,
`get_train_embedding` and `render` of `wildgaussians_tpu/models/
wildgaussians.py`. It reads the JAX package's checkpoint format (see
io/convert.py). Training, `optimize_embedding` and the uncertainty model are
not part of this package yet; a config with an uncertainty mode renders all
the same, since render never uses that model.
"""
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config, config_from_yaml_str
from ..device import resolve_device
from ..io.convert import params_from_numpy
from ..spans import span
from ..types import Cameras, RenderOutput, camera_model_to_int
from . import gaussian_store as gs
from .renderer import RenderPkg, render_internal


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class WildGaussians:
    """Renders a trained WildGaussians checkpoint on `device` (CUDA unless
    `device="cpu"` is passed)."""

    def __init__(self, *, checkpoint: str, device=None):
        self.device = resolve_device(device)
        if not os.path.isdir(checkpoint):
            raise RuntimeError(f"Model directory {checkpoint} does not exist")
        self.checkpoint = checkpoint
        with open(os.path.join(checkpoint, "config.yaml"), encoding="utf8") as f:
            self.config: Config = config_from_yaml_str(f.read())
        steps = sorted(int(x[x.find("-") + 1:x.find(".")])
                       for x in os.listdir(checkpoint)
                       if x.startswith("chkpnt-") and x.endswith(".npz"))
        if not steps:
            raise RuntimeError(f"no chkpnt-<step>.npz in {checkpoint}")
        self.step = steps[-1]
        if self.config.appearance_model_2D != "disabled":
            raise NotImplementedError("2D appearance models are not supported")
        if self.config.use_background_model:
            raise NotImplementedError("Background model is not supported")
        with np.load(os.path.join(checkpoint, f"chkpnt-{self.step}.npz"),
                     allow_pickle=False) as npz:
            state = params_from_numpy(npz, self.config, self.device)
        self.params, self.mlp, self.aux = state

    def get_embedding(self, train_image_id: Optional[int] = None) -> Optional[torch.Tensor]:
        if not self.config.appearance_enabled:
            return None
        if train_image_id is not None:
            return self.params["appearance_embeddings"][train_image_id]
        return torch.zeros_like(self.params["appearance_embeddings"][0])

    def get_train_embedding(self, index: int) -> Optional[np.ndarray]:
        e = self.get_embedding(index)
        return e.cpu().numpy() if e is not None else None

    @torch.no_grad()
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
