"""The blend's gradients: the port's autograd blend on the CPU (the plain
K2 and K3) against `jax.grad` through the JAX package's
`rasterize_pallas_multi(pack16=False)`, whose backward kernel runs in Pallas
interpret mode off the TPU and whose tier-2 merge is XLA's scatter there.

The scene has big Gaussians and a big pool (big_fraction 0.5) large enough
that nothing overflows while tier 2 carries gradient. Tolerance: atol
5e-3 max|g|, rtol 5e-2 per gradient, as tests/test_rasterize_pallas.py
holds the JAX package's own exact mode: the JAX backward rounds its
per-entry rows to f16 pairs, the port keeps them in f32.

One test (see test_torch_isolation.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_camera, make_scene
from wildgaussians_tpu.ops.rasterize_pallas import rasterize_pallas_multi
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_torch.cameras import make_camera_params
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
from wildgaussians_torch.ops.rasterize import engine_overflow_count
from wildgaussians_torch.ops.rasterize_tiled import make_grid

TOL_ATOL, TOL_RTOL = 5e-3, 5e-2
D_MAX, D_SMALL, BIG_FRACTION = 16, 4, 0.5
NDC = (40.0, 24.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed, n, width, height):
    """The port's preprocess of a seeded scene whose first fifth is scaled
    up four times (rects of 6-16 tiles: tier 2)."""
    rng = np.random.default_rng(seed)
    scene = make_scene(rng, n=n)
    scales = scene["scales"].copy()
    scales[: n // 5] *= 4.0
    cam, w, h = make_camera_params(make_camera(width=width, height=height))
    pre = preprocess(torch.tensor(scene["xyz"]),
                     compute_cov3d(torch.tensor(scales), torch.tensor(scene["rotations"])),
                     torch.tensor(scene["opacities"]), cam, w, h, 0.1)
    arrays = {k: v.numpy() for k, v in pre._asdict().items()}
    colors = [scene["colors"]] + [rng.uniform(0, 1, (n, 3)).astype(np.float32) for _ in range(2)]
    targets = rng.uniform(0, 1, (3, h, w, 3)).astype(np.float32)
    return arrays, colors, targets, w, h


_GEO = ("mean2d", "conic", "opacity")
_REST = ("depth", "rect_min", "rect_max", "tiles_touched", "valid")


def _loss(images, targets, xp):
    total = 0.0
    for (c, t), target in zip(images, targets):
        total = total + xp.mean((c - target) ** 2) + 0.1 * xp.mean(t)
    return total


def _jax_grads(arrays, colors, targets, bg, w, h):
    n = arrays["valid"].shape[0]

    def f(mean2d, conic, opacity, cols, hook, bg):
        out = rasterize_pallas_multi(
            mean2d, conic, opacity, list(cols), hook, *[jnp.asarray(arrays[k]) for k in _REST],
            bg, grid=jmake_grid(w, h, 16), max_tiles_per_gaussian=D_MAX, d_small=D_SMALL,
            big_fraction=BIG_FRACTION, pack16=False, ndc_scale=jnp.asarray(NDC))
        return _loss(out, jnp.asarray(targets), jnp)

    args = ([jnp.asarray(arrays[k]) for k in _GEO]
            + [tuple(jnp.asarray(c) for c in colors), jnp.zeros((n, 2), jnp.float32),
               jnp.asarray(bg)])
    g = jax.grad(f, argnums=tuple(range(6)))(*args)
    return [np.asarray(x) for x in g[:3]] + [np.stack([np.asarray(c) for c in g[3]]),
                                              np.asarray(g[4]), np.asarray(g[5])]


def _port_grads(arrays, colors, targets, bg, w, h, captured):
    n = arrays["valid"].shape[0]
    geo = [torch.tensor(arrays[k], requires_grad=True) for k in _GEO]
    cols = [torch.tensor(c, requires_grad=True) for c in colors]
    hook = torch.zeros((n, 2), requires_grad=True)
    bg_t = torch.tensor(bg, requires_grad=True)
    images, aux = tblend.rasterize_multi(
        *geo, cols, *[torch.tensor(arrays[k]) for k in _REST], bg_t, grid=make_grid(w, h, 16),
        max_tiles_per_gaussian=D_MAX, d_small=D_SMALL, big_fraction=BIG_FRACTION,
        absgrad_hook=hook, ndc_scale=NDC)
    g = torch.autograd.grad(_loss(images, torch.tensor(targets), torch), [*geo, *cols, hook, bg_t])
    overflow = engine_overflow_count(torch.tensor(arrays["tiles_touched"]), aux["vis_count"], D_MAX,
                              d_small=D_SMALL, big_fraction=BIG_FRACTION)
    return ([x.numpy() for x in g[:3]] + [torch.stack(g[3:3 + len(cols)]).numpy(),
                                          g[-2].numpy(), g[-1].numpy()], int(overflow), aux)


def test_blend_gradients_match_jax(monkeypatch):
    arrays, colors, targets, w, h = _scene(5, 150, 80, 48)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    merged = []
    plain_merge = tblend.tier2_merge

    def capture(sums, big_list, bigs):
        merged.append((big_list.clone(), bigs.clone()))
        return plain_merge(sums, big_list, bigs)
    monkeypatch.setattr(tblend, "tier2_merge", capture)
    for n_passes in (1, 3):
        merged.clear()
        got, overflow, aux = _port_grads(arrays, colors[:n_passes], targets[:n_passes], bg, w, h,
                                         merged)
        assert overflow == 0
        (big_list, bigs), = merged
        live = big_list < arrays["valid"].shape[0]
        assert int(live.sum()) > 0 and float(bigs[:, live].abs().max()) > 0, \
            "tier 2 carries no gradient"
        want = _jax_grads(arrays, colors[:n_passes], targets[:n_passes], bg, w, h)
        names = ("dmean2d", "dconic", "dopacity", "dcolors", "dabs", "dbg")
        for name, gw, gp in zip(names, want, got):
            assert gp.shape == gw.shape, name
            scale = np.abs(gw).max() + 1e-12
            np.testing.assert_allclose(gp, gw, atol=TOL_ATOL * scale, rtol=TOL_RTOL,
                                       err_msg=f"{name}, {n_passes} passes")
        assert np.abs(want[4][:, 0]).max() > 0 and np.all(want[4][:, 1] == 0)
