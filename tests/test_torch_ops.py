"""The port's cameras, preprocess, SH, tile layout and sort-engine sizes
against the JAX package, on the same numpy inputs: floats to rtol 1e-5 /
atol 1e-5, integer and boolean outputs exactly; and the gradients of cov3d,
preprocess and SH under torch autograd against `jax.grad` (rtol 1e-4, atol
1e-5 of the largest: the same chain, reassociated by two autodiffs). One
test (see test_torch_isolation.py); each check is a function of its own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildgaussians_tpu.cameras as jcam
from helpers import make_camera, make_scene
from wildgaussians_tpu.ops import gaussians as jgauss
from wildgaussians_tpu.ops import rasterize_pallas as jpal
from wildgaussians_tpu.ops import sh as jsh
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_torch import cameras as tcam
from wildgaussians_torch.ops import gaussians as tgauss
from wildgaussians_torch.ops import sh as tsh
from wildgaussians_torch.ops import sort_engine as tsort
from wildgaussians_torch.ops.rasterize_tiled import make_grid

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.tensor(np.asarray(x))


def _pose(rng):
    """A camera-to-world pose with a small random rotation and offset."""
    a = rng.normal(0, 0.1, 3)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + np.sin(0.5) * K + (1 - np.cos(0.5)) * K @ K
    u, _, vt = np.linalg.svd(R)
    return np.concatenate([u @ vt, rng.normal(0, 0.2, (3, 1))], axis=1).astype(np.float32)


def _check_cameras(rng):
    pose = _pose(rng)
    cam = make_camera(width=70, height=45, pose=pose)
    j, jw, jh = jcam.make_camera_params(cam)
    t, tw, th = tcam.make_camera_params(cam)
    assert (tw, th) == (jw, jh)
    for name in j._fields:
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   err_msg=name, **TOL)
    intr = cam.intrinsics[0]
    jt = jcam.make_camera_params_jax(jnp.asarray(pose), jnp.asarray(intr), 80, 48)
    tt = tcam.make_camera_params_torch(_t(pose), _t(intr), 80, 48)
    for name in jt._fields:
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                   err_msg=name, **TOL)


def _check_preprocess(rng):
    scene = make_scene(rng, n=300)
    scene["scales"][:30] *= 5.0          # some multi-tile footprints
    cam = make_camera(width=80, height=48, pose=_pose(rng))
    jparams, w, h = jcam.make_camera_params(cam)
    tparams = tcam.CameraParams(*[_t(x) for x in jparams])
    alive = rng.uniform(size=300) < 0.9

    jcov = jgauss.compute_cov3d(jnp.asarray(scene["scales"]), jnp.asarray(scene["rotations"]))
    tcov = tgauss.compute_cov3d(_t(scene["scales"]), _t(scene["rotations"]))
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), **TOL)

    filt = rng.uniform(0, 0.02, (300, 1)).astype(np.float32)
    js, jo = jgauss.apply_3d_filter(jnp.asarray(scene["scales"]),
                                    jnp.asarray(scene["opacities"][:, None]), jnp.asarray(filt))
    ts, to = tgauss.apply_3d_filter(_t(scene["scales"]), _t(scene["opacities"][:, None]), _t(filt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)

    # both preprocesses get the same covariance, so the comparison isolates them
    jpre = jgauss.preprocess(jnp.asarray(scene["xyz"]), jcov, jnp.asarray(scene["opacities"]),
                             jparams, w, h, 0.1, alive=jnp.asarray(alive))
    tpre = tgauss.preprocess(_t(scene["xyz"]), _t(jcov), _t(scene["opacities"]),
                             tparams, w, h, 0.1, alive=_t(alive))
    valid = np.asarray(jpre.valid)
    assert 50 < valid.sum() < 300
    for name in ("radius", "rect_min", "rect_max", "tiles_touched", "valid"):
        np.testing.assert_array_equal(getattr(tpre, name).numpy(), np.asarray(getattr(jpre, name)),
                                      err_msg=name)
    for name in ("mean2d", "depth", "conic", "opacity"):
        np.testing.assert_allclose(getattr(tpre, name).numpy()[valid],
                                   np.asarray(getattr(jpre, name))[valid], err_msg=name, **TOL)


def _check_eval_sh_switch(rng, degree):
    sh = rng.normal(0, 0.5, (64, 3, 16)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    j = jsh.eval_sh_switch(jnp.int32(degree), 3, jnp.asarray(sh), jnp.asarray(dirs))
    t = tsh.eval_sh_switch(torch.tensor(degree, dtype=torch.int32), 3, _t(sh), _t(dirs))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _check_gradients(rng):
    """A weighted sum of preprocess's float outputs and the degree-3 SH
    colors, differentiated in the means, scales, rotations, opacities and
    SH coefficients (the render path's chain below the blend)."""
    n = 80
    scene = make_scene(rng, n=n)
    sh = rng.normal(0, 0.3, (n, 3, 16)).astype(np.float32)
    cam = make_camera(width=80, height=48, pose=_pose(rng))
    jparams, w, h = jcam.make_camera_params(cam)
    tparams = tcam.CameraParams(*[_t(x) for x in jparams])
    weights = [rng.normal(size=s).astype(np.float32) for s in ((n, 2), (n, 3), (n,), (n, 3))]
    inputs = [scene[k] for k in ("xyz", "scales", "rotations", "opacities")] + [sh]

    def loss(xp, gauss, sh_mod, params, xyz, scales, rots, opac, shs):
        rots = rots / xp.linalg.norm(rots, axis=-1, keepdims=True) if xp is jnp else \
            rots / torch.linalg.norm(rots, dim=-1, keepdim=True)
        pre = gauss.preprocess(xyz, gauss.compute_cov3d(scales, rots), opac, params, w, h, 0.1)
        dirs = xyz - params.campos[None]
        dirs = dirs / (xp.linalg.norm(dirs, axis=-1, keepdims=True) if xp is jnp else
                       torch.linalg.norm(dirs, dim=-1, keepdim=True))
        colors = sh_mod.eval_sh(3, shs, dirs)
        ww = [xp.asarray(x) if xp is jnp else _t(x) for x in weights]
        m = pre.valid[:, None]
        return ((xp.where(m, pre.mean2d, 0.0) * ww[0]).sum()
                + (xp.where(m, pre.conic, 0.0) * ww[1]).sum() * 1e-3
                + (xp.where(pre.valid, pre.opacity, 0.0) * ww[2]).sum()
                + (colors * ww[3]).sum())

    jg = jax.jit(jax.grad(lambda *a: loss(jnp, jgauss, jsh, jparams, *a),
                          argnums=tuple(range(5))))(
        *[jnp.asarray(x) for x in inputs])
    tin = [_t(x).requires_grad_(True) for x in inputs]
    tg = torch.autograd.grad(loss(torch, tgauss, tsh, tparams, *tin), tin)
    for name, a, b in zip(("xyz", "scales", "rotations", "opacities", "sh"), tg, jg):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * np.abs(b).max(),
                                   err_msg=f"gradient of {name}")


def _check_tile_layout(rng, size, channels):
    from wildgaussians_tpu.ops import rasterize_tiled as jrt
    from wildgaussians_torch.ops import rasterize_tiled as trt
    w, h = size
    img = rng.uniform(size=(h, w, *channels)).astype(np.float32)
    jgrid, tgrid = jrt.make_grid(w, h, 16), trt.make_grid(w, h, 16)
    assert tuple(tgrid) == tuple(jgrid) and tgrid.num_tiles == jgrid.num_tiles
    jt = np.asarray(jrt.image_to_tiles(jnp.asarray(img), jgrid, fill=0.5))
    tt = trt.image_to_tiles(_t(img), tgrid, fill=0.5)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(trt.tiles_to_image(tt, tgrid).numpy(), img)


def _check_sort_engine_sizes():
    grid_j, grid_t = jmake_grid(80, 48, 16), make_grid(80, 48, 16)
    for n, d_small, frac in ((300, 2, 0.02), (5, 4, 0.16), (1000, 16, 0.16)):
        j = jpal._sort_engine_sizes(grid_j, 256, n, 16, 3, d_small, frac, False)
        t = tsort._sort_engine_sizes(grid_t, n, 16, d_small, frac)
        assert (t.d1, t.d2_extra, t.m_cap, t.R, t.depth_bits) == (*j[:4], j[7])


def test_ops_match_jax():
    _check_cameras(np.random.default_rng(42))
    _check_preprocess(np.random.default_rng(42))
    for degree in (0, 1, 2, 3):
        _check_eval_sh_switch(np.random.default_rng(42), degree)
    _check_gradients(np.random.default_rng(42))
    for size, channels in (((70, 45), (3,)), ((32, 16), ())):
        _check_tile_layout(np.random.default_rng(42), size, channels)
    _check_sort_engine_sizes()
