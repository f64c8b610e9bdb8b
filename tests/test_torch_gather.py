"""The port's gather engine (`pallas_binning: gather`) on the CPU, with the
plain K1 and K2, against the JAX package's `rasterize_pallas_multi(...,
binning="gather", pack16=False)`, whose kernels run in Pallas interpret mode
off the TPU. The same preprocess arrays (the port's, from the partition
engine test's tie-free scene: 2 color passes, inflated Gaussians that need
tier 2, one behind the camera, more big Gaussians than the pool holds) go
to both. Compared: images and final T within 1e-5, and the gradients of
mean2d, conic, opacity, the colors, the abs-gradient hook (per axis, scaled
by ndc_scale) and bg, each within 1e-4 of its largest |g|, from a cotangent
that reaches both passes and from one that reaches only the first.

Then one training step under `pallas_binning: gather` (`step_against_jax`,
shared with test_torch_tiled_backend.py): the port's `WildGaussians` against
the JAX trainer on test_torch_train_step.py's dataset, the metrics to rtol
1e-4 and every parameter's gradient as that test holds them.

One test (see test_torch_isolation.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildgaussians_tpu.models.gaussian_store as jgs
import wildgaussians_tpu.models.wildgaussians as jwg
import wildgaussians_tpu.ops.knn_native as jknn_native
from test_torch_partition_engine import _GEO, _REST, _scene
from test_torch_train_step import _close, _dataset, _jax_flat, _port_layout
from wildgaussians_tpu.ops import rasterize_pallas as jpal
from wildgaussians_tpu.ops.knn import mean_knn_dist2 as jknn
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_tpu.types import new_cameras as jcameras
from wildgaussians_torch import WildGaussians
import wildgaussians_torch.models.gaussian_store as gs
import wildgaussians_torch.models.wildgaussians as twg
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops.rasterize_tiled import make_grid
from wildgaussians_torch.ops.sort_engine import _sort_engine_sizes
from wildgaussians_torch.types import new_cameras

N, W, H = 100, 80, 48
D_MAX, D_SMALL, BIG_FRACTION = 16, 4, 0.02   # d1 = 6 (the engine's floor), m_cap = 8
NDC = (40.0, 24.0)
TOL_IMG, TOL_GRAD = 1e-5, 1e-4
METRIC_RTOL = 1e-4
STEP_OVERRIDES = dict(uncertainty_mode="disabled", rasterizer_backend="pallas",
                      pallas_pack16=False, num_sky_gaussians=400, max_tiles_per_gaussian=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run(arrays, colors, bg, cots):
    def f(mean2d, conic, opacity, cols, hook, bg):
        out = jpal.rasterize_pallas_multi(
            mean2d, conic, opacity, list(cols), hook, *[jnp.asarray(arrays[k]) for k in _REST],
            bg, grid=jmake_grid(W, H, 16), max_tiles_per_gaussian=D_MAX, d_small=D_SMALL,
            big_fraction=BIG_FRACTION, binning="gather", pack16=False,
            ndc_scale=jnp.asarray(NDC))
        return [x for pair in out for x in pair]

    def outs_and_vjps(args, cots):
        outs, f_vjp = jax.vjp(f, *args)
        return outs, [f_vjp(cot) for cot in cots]

    args = ([jnp.asarray(arrays[k]) for k in _GEO]
            + [tuple(jnp.asarray(c) for c in colors), jnp.zeros((N, 2), jnp.float32),
               jnp.asarray(bg)])
    # one XLA program (the forward and both pullbacks) compiles in about a
    # third of the time of eager dispatch
    outs, vjps = jax.jit(outs_and_vjps)(args, [[jnp.asarray(c) for c in cot] for cot in cots])
    grads = []
    for g in vjps:
        grads.append([np.asarray(x) for x in g[:3]]
                     + [np.stack([np.asarray(c) for c in g[3]]), np.asarray(g[4]),
                        np.asarray(g[5])])
    return [np.asarray(o) for o in outs], grads


def _port_run(arrays, colors, bg, cots):
    geo = [torch.tensor(arrays[k], requires_grad=True) for k in _GEO]
    cols = [torch.tensor(c, requires_grad=True) for c in colors]
    hook = torch.zeros((N, 2), requires_grad=True)
    bg_t = torch.tensor(bg, requires_grad=True)
    images, aux = tblend.rasterize_multi(
        *geo, cols, *[torch.tensor(arrays[k]) for k in _REST], bg_t, grid=make_grid(W, H, 16),
        max_tiles_per_gaussian=D_MAX, d_small=D_SMALL, big_fraction=BIG_FRACTION,
        binning="gather", absgrad_hook=hook, ndc_scale=NDC)
    (c0, t0), (c1, t1) = images
    grads = []
    for cot in cots:
        g = torch.autograd.grad([c0, t0, c1, t1], [*geo, *cols, hook, bg_t],
                                grad_outputs=[torch.tensor(c) for c in cot], retain_graph=True)
        grads.append([x.numpy() for x in g[:3]] + [torch.stack(g[3:5]).numpy(),
                                                   g[5].numpy(), g[6].numpy()])
    return [o.detach().numpy() for o in (c0, t0, c1, t1)], grads, aux


def _check_engine():
    arrays, colors, rng = _scene(11)
    assert not arrays["valid"][20]
    sz = _sort_engine_sizes(make_grid(W, H, 16), N, D_MAX, max(D_SMALL, 6), BIG_FRACTION)
    assert int(np.sum((np.minimum(arrays["tiles_touched"], D_MAX) > sz.d1)
                      & arrays["valid"])) > sz.m_cap, "the big pool must overflow"
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    shapes = [(H, W, 3), (H, W), (H, W, 3), (H, W)]
    full = [rng.normal(0, 1e-2, s).astype(np.float32) for s in shapes]
    first_only = [full[0], full[1], np.zeros(shapes[2], np.float32),
                  np.zeros(shapes[3], np.float32)]
    cots = [full, first_only]
    j_out, j_grads = _jax_run(arrays, colors, bg, cots)
    t_out, t_grads, aux = _port_run(arrays, colors, bg, cots)
    # the table is the attribute rows gathered at each binned entry's Gaussian
    gid = aux["gid"].numpy()
    assert gid.shape[0] == int(aux["tile_starts"][-1]) > 0 and gid.max() < N
    np.testing.assert_array_equal(aux["table"][0].numpy(), arrays["mean2d"][gid, 0])
    np.testing.assert_array_equal(aux["big_list"].numpy()[:3],
                                  np.nonzero((np.minimum(arrays["tiles_touched"], D_MAX) > sz.d1)
                                             & arrays["valid"])[0][:3])
    for name, jo, to in zip(("color 0", "T 0", "color 1", "T 1"), j_out, t_out):
        np.testing.assert_allclose(to, jo, atol=TOL_IMG, rtol=0, err_msg=name)
    names = ("dmean2d", "dconic", "dopacity", "dcolors", "dabs", "dbg")
    for k, (want, got) in enumerate(zip(j_grads, t_grads)):
        for name, gw, gp in zip(names, want, got):
            assert gp.shape == gw.shape, name
            scale = np.abs(gw).max()
            assert scale > 0, f"{name} has no gradient"
            np.testing.assert_allclose(gp, gw, atol=TOL_GRAD * scale, rtol=0,
                                       err_msg=f"{name}, cotangent {k}")


def step_against_jax(monkeypatch, overrides, before_step=None):
    """One training step of the port's `WildGaussians` against the JAX
    trainer's under `overrides`, from the same store (SH degree 3 and
    anisotropic Gaussians, so that every parameter gets a gradient): the
    metrics to rtol METRIC_RTOL and each parameter's gradient, read where
    each side hands it to `adam_update`, as test_torch_train_step.py holds
    them. `before_step(jax_model, port_model)` runs on the two models just
    before their steps. Returns the port's metrics."""
    monkeypatch.setattr(jknn_native, "available", lambda: False)
    monkeypatch.setattr(twg, "mean_knn_dist2",
                        lambda t: torch.as_tensor(np.asarray(jknn(jnp.asarray(t.numpy())))))
    jm = jwg.WildGaussians(train_dataset=_dataset(jcameras), config_overrides=dict(overrides))
    tm = WildGaussians(train_dataset=_dataset(new_cameras), config_overrides=dict(overrides),
                       device="cpu")
    jm.aux = jm.aux._replace(active_sh_degree=jnp.int32(3))
    tm.aux = tm.aux._replace(active_sh_degree=torch.tensor(3, dtype=torch.int32))
    rng = np.random.default_rng(0)
    for k, sigma in (("scales", 0.3), ("rotations", 0.2)):
        v = tm.params[k].detach().numpy()
        v = (v + rng.normal(0, sigma, v.shape)).astype(np.float32)
        jm.params[k] = jnp.asarray(v)
        with torch.no_grad():
            tm.params[k].copy_(torch.tensor(v))
    if before_step is not None:
        before_step(jm, tm)
    captured = {}

    def t_capture(params, grads, state, lrs, weight_decay=None):
        captured.update({k: g.detach().clone() for k, g in grads.items()})
        return state
    monkeypatch.setattr(jgs, "adam_update", lambda p, g, s, lrs, weight_decay=None: (g, s))
    monkeypatch.setattr(gs, "adam_update", t_capture)
    jmetrics = jm.train_iteration(0, camera_id=1)
    tmetrics = tm.train_iteration(0, camera_id=1)
    for k, v in tmetrics.items():
        np.testing.assert_allclose(v, jmetrics[k], rtol=METRIC_RTOL, err_msg=k)
    jgrads = _jax_flat(jm.params)
    alive = tm.aux.alive.numpy()
    for k, g in captured.items():
        want, got = _port_layout(k, jgrads[k]), g.numpy()
        if want.shape[0] == alive.shape[0]:
            want, got = want[alive], got[alive]
        assert np.abs(want).max() > 0, f"{k} has no gradient"
        _close(got, want, f"gradient of {k}")
    for field in ("xyz_grad", "xyz_gradient_accum_abs", "xyz_gradient_accum_abs_max"):
        _close(getattr(tm.aux, field).numpy(), np.asarray(getattr(jm.aux, field)), field)
    return tmetrics


def test_gather_engine_matches_jax(monkeypatch):
    _check_engine()
    step_against_jax(monkeypatch, dict(STEP_OVERRIDES, pallas_binning="gather"))
