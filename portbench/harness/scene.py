"""The cell's inputs, made on the device from the seed: a stand-in for a
converged WildGaussians scene, its training cameras and photos, the
trained state a resumed run starts from, and random DINOv2 weights.

The geometry is a frozen copy of the program's surfel scene (a ground
plane, a back wall and 80 spheres of flat, mostly opaque Gaussians in the
frustum of an identity camera with f = 1280 / 1.4), plus the program's sky:
a Fibonacci sphere at ten times the scene's 97th-percentile radius, kept
where a training camera sees it in the top two thirds of its image or does
not see it at all. The spheres' layout and the cameras are fixed (`LAYOUT`);
the seed draws the Gaussians on them, their appearance, the photos, the
state and the order of the cameras, so that every seed sets the same work.
"""
import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

LAYOUT = 20251018          # the seed of what every run shares: sphere layout, cameras
C0 = 0.28209479177387814
FOCAL_OF_WIDTH = 1.4       # f = 1280 / 1.4, as in the program's surfel scene


def gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def uniform(g, shape, lo, hi, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def normal(g, shape, std, device):
    return torch.randn(shape, generator=g, device=device) * std


def _quat_from_normal(g, nrm: torch.Tensor) -> torch.Tensor:
    """Quaternions (w, x, y, z) turning +z onto each normal, then a random
    spin about it."""
    n = nrm.shape[0]
    dev = nrm.device
    z = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3)
    v = torch.linalg.cross(z, nrm)
    w = 1.0 + nrm[:, 2]
    q = torch.cat([w[:, None], v], 1)
    q = torch.where((w < 1e-6)[:, None], torch.tensor([0.0, 1.0, 0.0, 0.0], device=dev), q)
    q = q / q.norm(dim=1, keepdim=True)
    ang = uniform(g, (n,), 0.0, math.pi, dev)
    a0, a1, a2, a3 = q.unbind(1)
    b0, b3 = torch.cos(ang), torch.sin(ang)
    return torch.stack([a0 * b0 - a3 * b3, a1 * b0 + a2 * b3, a2 * b0 - a1 * b3,
                        a3 * b0 + a0 * b3], 1)


class Gaussians(NamedTuple):
    xyz: torch.Tensor
    scales: torch.Tensor      # activated
    quat: torch.Tensor
    opacity: torch.Tensor     # activated
    color: torch.Tensor       # RGB in [0, 1]


def surfels(g, n: int, device, width: int = 1280, height: int = 720) -> Gaussians:
    """The surfel scene of n Gaussians (the program's `make_surfel_scene`,
    on the device, the spheres from LAYOUT)."""
    f = width / FOCAL_OF_WIDTH
    fr = torch.tensor([width / (2 * f), height / (2 * f)], device=device)
    n_ground, n_wall = int(n * 0.35), int(n * 0.25)
    n_sph = n - n_ground - n_wall
    zg = uniform(g, (n_ground,), 3.0, 28.0, device)
    xg = uniform(g, (n_ground,), -1.0, 1.0, device) * zg * fr[0]
    ground = torch.stack([xg, torch.ones_like(zg), zg], 1)
    ext = 28.0 * fr
    wall = torch.stack([uniform(g, (n_wall,), -1.0, 1.0, device) * ext[0],
                        uniform(g, (n_wall,), -1.0, 1.0, device) * ext[1],
                        torch.full((n_wall,), 28.0, device=device)], 1)
    lg = gen(LAYOUT, device)
    k = 80
    sz = uniform(lg, (k,), 4.0, 22.0, device)
    sxy = uniform(lg, (k, 2), -0.8, 0.8, device) * fr * sz[:, None]
    centres = torch.cat([sxy, sz[:, None]], 1)
    radii = uniform(lg, (k,), 0.3, 1.6, device)
    wgt = (radii / sz) ** 2
    counts = torch.clamp_min((wgt / wgt.sum() * n_sph).long(), 1)
    counts[-1] += n_sph - counts.sum()
    which = torch.repeat_interleave(torch.arange(k, device=device), counts)
    d = normal(g, (n_sph, 3), 1.0, device)
    d = d / d.norm(dim=1, keepdim=True)
    spheres = centres[which] + radii[which, None] * d
    xyz = torch.cat([ground, wall, spheres])
    nrm = torch.cat([torch.tensor([0.0, -1.0, 0.0], device=device).expand(n_ground, 3),
                     torch.tensor([0.0, 0.0, -1.0], device=device).expand(n_wall, 3), d])
    px = xyz[:, 2] / f
    t = px * uniform(g, (n,), 1.0, 3.0, device)
    scales = torch.stack([t, t * uniform(g, (n,), 0.6, 1.0, device), t * 0.15], 1)
    quat = _quat_from_normal(g, nrm)
    hi = uniform(g, (n,), 0.85, 0.995, device)
    lo = uniform(g, (n,), 0.08, 0.85, device)
    opacity = torch.where(uniform(g, (n,), 0.0, 1.0, device) < 0.7, hi, lo).clamp(0.0, 0.995)
    ph = xyz @ normal(g, (3, 3), 0.8, device) + uniform(g, (3,), 0.0, 6.28, device)
    color = (0.5 + 0.45 * torch.sin(ph)).clamp(0.0, 1.0)
    return Gaussians(xyz, scales, quat, opacity, color)


class Cam(NamedTuple):
    pose: torch.Tensor        # [3, 4] camera to world
    intr: tuple               # fx, fy, cx, cy
    size: tuple               # w, h


def _pose(yaw, t, device):
    c, s = math.cos(yaw), math.sin(yaw)
    return torch.tensor([[c, 0, s, t[0]], [0, 1, 0, t[1]], [-s, 0, c, t[2]]],
                        dtype=torch.float32, device=device)


def cameras(n: int, sizes, device) -> List[Cam]:
    """n training cameras near the identity camera (yaw within 0.08 rad,
    offsets within the program's serving poses' range), sizes in turn,
    each with the surfel scene's field of view along its long side
    (f = long side / 1.4)."""
    rng = np.random.default_rng(LAYOUT)
    out = []
    for i in range(n):
        yaw = rng.uniform(-0.08, 0.08)
        t = (rng.uniform(-0.5, 0.5), rng.uniform(-0.15, 0.15), rng.uniform(-0.5, 1.0))
        w, h = sizes[i % len(sizes)]
        f = max(w, h) / FOCAL_OF_WIDTH
        out.append(Cam(_pose(yaw, t, device), (f, f, w / 2, h / 2), (w, h)))
    return out


def view_poses(n: int, width: int, height: int, device) -> List[Cam]:
    """n viewer poses around the program's four serving poses
    ((yaw, offset) of chip_smoke.py's POSE_PARAMS), within 0.03 rad and
    0.2 of each."""
    base = ((0.0, (0.0, 0.0, 0.0)), (0.06, (0.4, -0.1, 0.5)),
            (-0.08, (-0.5, 0.1, 1.0)), (0.03, (0.2, 0.15, -0.5)))
    rng = np.random.default_rng(LAYOUT + 1)
    f = 1280 / FOCAL_OF_WIDTH
    out = []
    for i in range(n):
        yaw, t = base[i % len(base)]
        yaw += rng.uniform(-0.03, 0.03)
        t = tuple(v + rng.uniform(-0.2, 0.2) for v in t)
        out.append(Cam(_pose(yaw, t, device), (f, f, width / 2, height / 2), (width, height)))
    return out


def sky(g, n_candidates: int, xyz: torch.Tensor, cams: List[Cam]) -> Gaussians:
    """The program's sky candidates (a Fibonacci sphere at ten times the
    97th-percentile distance from the points' mean), kept as the program
    keeps them, as converged sky Gaussians 2-5 px across."""
    dev = xyz.device
    i = torch.linspace(-(n_candidates - 1) / 2, (n_candidates - 1) / 2, n_candidates, device=dev,
                       dtype=torch.float64)
    lat = torch.asin(2.0 * i / n_candidates)
    lon = math.pi * (3.0 - math.sqrt(5.0)) * i
    unit = torch.stack([torch.cos(lon) * torch.cos(lat), torch.sin(lon) * torch.cos(lat),
                        torch.sin(lat)], 1).to(torch.float32)
    mean = xyz.mean(0)
    sample = xyz[torch.randint(0, xyz.shape[0], (200_000,), generator=g, device=dev)]
    dist = float(torch.quantile((sample - mean).norm(dim=1), 0.97)) * 10
    pts = unit * dist + mean
    keep = torch.zeros(n_candidates, dtype=torch.bool, device=dev)
    for cam in cams:
        rot, org = cam.pose[:, :3], cam.pose[:, 3]
        c = (pts - org) @ rot
        v = torch.where(c[:, 2] > 1e-7, c[:, 1] / c[:, 2] * cam.intr[1] + cam.intr[3],
                        torch.zeros_like(c[:, 2]))
        keep |= v < 2.0 / 3.0 * cam.size[1]
    pts = pts[keep]
    m = pts.shape[0]
    depth = (pts - mean).norm(dim=1)
    s = depth / (1280 / FOCAL_OF_WIDTH) * uniform(g, (m,), 2.0, 5.0, dev)
    q = normal(g, (m, 4), 1.0, dev)
    base = torch.tensor([237.0, 247.0, 252.0], device=dev) / 255.0
    color = (base + normal(g, (m, 3), 0.03, dev)).clamp(0.0, 1.0)
    return Gaussians(pts, s[:, None].expand(m, 3).contiguous(), q / q.norm(dim=1, keepdim=True),
                     uniform(g, (m,), 0.9, 0.99, dev), color)


def photos(g, cams: List[Cam], device) -> List[torch.Tensor]:
    """One photo per camera: a smooth colour field under the photo's own
    exposure and tint, with 2-4 opaque occluders (ellipses of one colour)
    covering a few percent of it each: what appearance embeddings and the
    uncertainty model exist for."""
    out = []
    for cam in cams:
        w, h = cam.size
        coarse = uniform(g, (1, 3, 6, 10), 0.15, 0.85, device)
        img = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bicubic",
                                              align_corners=False)[0].permute(1, 2, 0)
        img = img * uniform(g, (1,), 0.6, 1.4, device) * uniform(g, (3,), 0.9, 1.1, device)
        yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
        xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
        k = int(torch.randint(2, 5, (1,), generator=g, device=device))
        for _ in range(k):
            cx, cy = (uniform(g, (2,), 0.1, 0.9, device) * torch.tensor([w, h], device=device))
            rx, ry = uniform(g, (2,), 0.05, 0.15, device) * min(w, h)
            inside = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
            img = torch.where(inside[..., None], uniform(g, (3,), 0.0, 1.0, device), img)
        out.append(img.clamp(0.0, 1.0).contiguous())
    return out


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def vit_weights(g, device, dim=384, depth=12, heads=6, patch=14, registers=4, grid=37,
                mlp_ratio=4, layer_scale=1.0) -> Dict[str, torch.Tensor]:
    """Random DINOv2 ViT-S/14-reg4 weights under the public checkpoint's
    names (N(0, 0.02) matrices, zero biases, unit norms)."""
    w: Dict[str, torch.Tensor] = {
        "patch_embed.proj.weight": normal(g, (dim, 3, patch, patch), 0.02, device),
        "patch_embed.proj.bias": torch.zeros(dim, device=device),
        "cls_token": normal(g, (1, 1, dim), 1e-6, device),
        "register_tokens": normal(g, (1, registers, dim), 1e-6, device),
        "pos_embed": normal(g, (1, 1 + grid * grid, dim), 0.02, device),
        "norm.weight": torch.ones(dim, device=device),
        "norm.bias": torch.zeros(dim, device=device),
    }
    hid = dim * mlp_ratio
    for i in range(depth):
        p = f"blocks.{i}."
        w.update({
            p + "norm1.weight": torch.ones(dim, device=device),
            p + "norm1.bias": torch.zeros(dim, device=device),
            p + "attn.qkv.weight": normal(g, (3 * dim, dim), 0.02, device),
            p + "attn.qkv.bias": torch.zeros(3 * dim, device=device),
            p + "attn.proj.weight": normal(g, (dim, dim), 0.02, device),
            p + "attn.proj.bias": torch.zeros(dim, device=device),
            p + "ls1.gamma": torch.full((dim,), layer_scale, device=device),
            p + "norm2.weight": torch.ones(dim, device=device),
            p + "norm2.bias": torch.zeros(dim, device=device),
            p + "mlp.fc1.weight": normal(g, (hid, dim), 0.02, device),
            p + "mlp.fc1.bias": torch.zeros(hid, device=device),
            p + "mlp.fc2.weight": normal(g, (dim, hid), 0.02, device),
            p + "mlp.fc2.bias": torch.zeros(dim, device=device),
            p + "ls2.gamma": torch.full((dim,), layer_scale, device=device),
        })
    return w
