"""Seeded synthetic scenes and checkpoints for smoke tests and measurement.

`make_surfel_scene` is the port's own copy of the converged-scene stand-in of
the repository's `bench.py`: surface-attached, flat Gaussians with bimodal
opacities, which saturate transmittance the way a trained scene does.
`make_random_scene` is its copy of `bench.py`'s random scene, which never
saturates.
`surfel_state` turns such a scene into a full WildGaussians parameter state
in the JAX package's checkpoint layout (random appearance weights drawn as
the JAX package's `init_mlp` draws them), so that it loads through
`WildGaussians`.
"""
import os
from typing import Dict

import numpy as np

from .config import Config, load_config_yaml
from .io.convert import save_checkpoint
from .models.appearance import init_mlp
from .ops.sh import C0


def make_random_scene(rng: np.random.Generator, n_gaussians: int, width: int, height: int,
                      f: float):
    """Uniform random Gaussians in the frustum of an identity camera with
    focal length f: depths 3-30, footprints of 1-4 px sigma, opacities
    0.4-0.99 and random colors. Their opacities never saturate
    transmittance, so every tile walks its whole entry list. Returns
    activated (xyz, scales, rotations, opacities, colors)."""
    z = rng.uniform(3.0, 30.0, n_gaussians).astype(np.float32)
    xy_extent = z[:, None] * np.array([width / (2 * f), height / (2 * f)], np.float32)
    xyz = np.concatenate([
        rng.uniform(-1, 1, (n_gaussians, 2)).astype(np.float32) * xy_extent,
        z[:, None]], -1)
    px_size = z / f  # world size of one pixel at that depth
    scales = (px_size[:, None] * rng.uniform(0.8, 4.0, (n_gaussians, 3))).astype(np.float32)
    q = rng.normal(size=(n_gaussians, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.uniform(0.4, 0.99, n_gaussians).astype(np.float32)
    colors = rng.uniform(0, 1, (n_gaussians, 3)).astype(np.float32)
    return xyz, scales, q, opac, colors


def _quat_from_normal(rng, normal):
    """Quaternions rotating +z to each row of `normal` [n,3], plus a random
    spin about the normal."""
    n = normal.shape[0]
    z = np.array([0.0, 0.0, 1.0], np.float32)
    v = np.cross(np.broadcast_to(z, normal.shape), normal)
    c = normal @ z
    w = 1.0 + c
    q = np.concatenate([w[:, None], v], axis=1).astype(np.float32)
    bad = w < 1e-6   # antiparallel rows: any 180-degree axis works
    q[bad] = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ang = rng.uniform(0, np.pi, n).astype(np.float32)
    spin = np.stack([np.cos(ang), np.zeros(n, np.float32),
                     np.zeros(n, np.float32), np.sin(ang)], axis=1)
    a, b = q, spin
    return np.stack([
        a[:, 0] * b[:, 0] - a[:, 1] * b[:, 1] - a[:, 2] * b[:, 2] - a[:, 3] * b[:, 3],
        a[:, 0] * b[:, 1] + a[:, 1] * b[:, 0] + a[:, 2] * b[:, 3] - a[:, 3] * b[:, 2],
        a[:, 0] * b[:, 2] - a[:, 1] * b[:, 3] + a[:, 2] * b[:, 0] + a[:, 3] * b[:, 1],
        a[:, 0] * b[:, 3] + a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1] + a[:, 3] * b[:, 0],
    ], axis=1).astype(np.float32)


def make_surfel_scene(rng: np.random.Generator, n_gaussians: int, width: int,
                      height: int, f: float):
    """A ground plane, a back wall and a field of spheres filling the
    frustum of an identity camera with focal length f. Returns activated
    (xyz, scales, rotations, opacities, colors)."""
    def in_frustum_xy(z, margin=1.0):
        return np.multiply.outer(
            np.asarray(z, np.float32),
            np.array([width / (2 * f), height / (2 * f)], np.float32)) * margin

    parts = []  # (xyz, normal)
    n_ground = int(n_gaussians * 0.35)
    n_wall = int(n_gaussians * 0.25)
    n_sph = n_gaussians - n_ground - n_wall
    zg = rng.uniform(3.0, 28.0, n_ground).astype(np.float32)
    xg = rng.uniform(-1, 1, n_ground).astype(np.float32) * in_frustum_xy(zg)[:, 0]
    g_xyz = np.stack([xg, np.full(n_ground, 1.0, np.float32), zg], axis=1)
    parts.append((g_xyz, np.tile(np.array([0, -1, 0], np.float32), (n_ground, 1))))
    ext = in_frustum_xy(np.float32(28.0))
    w_xyz = np.stack([
        rng.uniform(-ext[0], ext[0], n_wall).astype(np.float32),
        rng.uniform(-ext[1], ext[1], n_wall).astype(np.float32),
        np.full(n_wall, 28.0, np.float32)], axis=1)
    parts.append((w_xyz, np.tile(np.array([0, 0, -1], np.float32), (n_wall, 1))))
    n_spheres = 80
    sc_z = rng.uniform(4.0, 22.0, n_spheres).astype(np.float32)
    sc_xy = rng.uniform(-0.8, 0.8, (n_spheres, 2)).astype(np.float32) * in_frustum_xy(sc_z)
    centers = np.concatenate([sc_xy, sc_z[:, None]], axis=1)
    radii = rng.uniform(0.3, 1.6, n_spheres).astype(np.float32)
    # points per sphere proportional to projected solid angle ~ (r/z)^2
    wgt = (radii / sc_z) ** 2
    counts = np.maximum((wgt / wgt.sum() * n_sph).astype(np.int64), 1)
    counts[-1] += n_sph - counts.sum()
    sp_xyz, sp_nrm = [], []
    for ctr, r, m in zip(centers, radii, counts):
        if m <= 0:
            continue
        d = rng.normal(size=(m, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        sp_xyz.append(ctr[None] + r * d)
        sp_nrm.append(d)
    parts.append((np.concatenate(sp_xyz), np.concatenate(sp_nrm)))

    xyz = np.concatenate([p[0] for p in parts])[:n_gaussians]
    normal = np.concatenate([p[1] for p in parts])[:n_gaussians]
    z = xyz[:, 2]
    px_size = z / f
    # flat surfels: tangent sigma ~1-3 px, normal sigma 0.15x tangent
    tangent = (px_size * rng.uniform(1.0, 3.0, n_gaussians)).astype(np.float32)
    scales = np.stack([tangent, tangent * rng.uniform(0.6, 1.0, n_gaussians).astype(np.float32),
                       tangent * 0.15], axis=1)
    q = _quat_from_normal(rng, normal)
    # bimodal converged opacities: 70% near-opaque, 30% mid/floaters
    hi = rng.uniform(0.85, 0.995, n_gaussians)
    lo = rng.uniform(0.08, 0.85, n_gaussians)
    opac = np.where(rng.uniform(size=n_gaussians) < 0.7, hi, lo).astype(np.float32)
    # spatially-correlated "texture": low-frequency trig mix of position
    ph = xyz @ rng.normal(0, 0.8, (3, 3)).astype(np.float32)
    colors = (0.5 + 0.45 * np.sin(ph + rng.uniform(0, 6.28, 3).astype(np.float32))
              ).astype(np.float32)
    return xyz, scales, q, np.clip(opac, 0.0, 0.995), np.clip(colors, 0.0, 1.0)


NUM_IMAGES = 8   # image embeddings in a synthetic checkpoint


def surfel_state(config: Config, n_gaussians: int, width: int, height: int,
                 f: float, seed: int) -> Dict[str, np.ndarray]:
    """A WildGaussians state for a surfel scene, as the flat `params/...`,
    `aux/...` arrays of the JAX package's checkpoint (see io/convert.py).

    The scene's colors become the SH DC terms (with small random higher
    bands); the per-Gaussian and image embeddings and the appearance MLP
    (the JAX package's init) are random, from `seed`. The 3D filter is a
    fifth of a pixel at each Gaussian's depth."""
    rng = np.random.default_rng(seed)
    xyz, scales, rots, opac, colors = make_surfel_scene(rng, n_gaussians, width, height, f)
    f32 = np.float32
    shdim = (config.sh_degree + 1) ** 2
    opac = np.clip(opac, 1e-4, 1 - 1e-4)
    flat = {
        "params/xyz": xyz.astype(f32),
        "params/features_dc": ((colors - 0.5) / C0).astype(f32),
        "params/scales": np.log(scales).astype(f32),
        "params/rotations": rots.astype(f32),
        "params/opacities": np.log(opac / (1 - opac)).astype(f32)[:, None],
        "aux/alive": np.ones(n_gaussians, bool),
        "aux/filter_3D": (0.2 * xyz[:, 2:3] / f).astype(f32),
        "aux/active_sh_degree": np.asarray(config.sh_degree, np.int32),
    }
    if config.sh_degree > 0:
        flat["params/features_rest"] = rng.normal(0, 0.02, (n_gaussians, (shdim - 1) * 3)).astype(f32)
    if config.appearance_enabled:
        flat["params/embeddings"] = rng.normal(
            0, 1, (n_gaussians, 6 * config.appearance_n_fourier_freqs)).astype(f32)
        flat["params/appearance_embeddings"] = rng.normal(
            0, 0.5, (NUM_IMAGES, config.appearance_embedding_dim)).astype(f32)
        for k, v in init_mlp(rng, config).items():   # the checkpoint keeps [in, out]
            flat[f"params/appearance_mlp/{k}"] = v
    return flat


def write_surfel_checkpoint(path: str, n_gaussians: int, width: int, height: int,
                            seed: int) -> str:
    """Write a surfel-scene checkpoint with the config `configs/default.yml`
    for an identity camera with f = width / 1.4; returns `path`."""
    config = load_config_yaml(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "configs", "default.yml"))
    flat = surfel_state(config, n_gaussians, width, height, width / 1.4, seed)
    return save_checkpoint(path, config, flat)
