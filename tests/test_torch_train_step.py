"""One training step of the port's `WildGaussians` against the JAX
package's, on a seeded 64x48 dataset (a `helpers.make_scene` point cloud,
uint8 photos with occluder masks, sky points, SH degree 3, appearance on),
the JAX side with `rasterizer_backend="pallas"`, `pallas_pack16=False`
(its Pallas kernels in interpret mode) and both with the uncertainty model
disabled and a tile budget of 4 (some rects truncated, on both sides).

Checked: the initial store is bit-identical (both sides get the JAX 3-NN
distances); the metrics agree to rtol 1e-4 (the blended images agree to
~1e-5); every parameter's gradient of the live slots agrees to atol 5e-3
max|g| and rtol 5e-2, as tests/test_rasterize_pallas.py holds the JAX
exact mode; so do the densification statistics built from the hook
gradients (`denom` and `max_radii2D` exactly). The JAX backward rounds its
per-entry rows to f16 (saturating at 65504, flushing below 2^-24); on this
scene a Gaussian just in front of one camera (a radius of thousands of
pixels) saturates, which moves its xyz gradient by ~100 % of the largest.
So the port's step runs here with its K2 rows rounded the same way (a
wrapper around the plain K2, in this test only), and then agrees to ~1e-5
of each gradient's largest value; test_torch_blend_bwd.py holds the port's
f32 rows against JAX on a scene where nothing saturates. (Dead slots'
rotation gradients are NaN in JAX, the derivative of the norm at 0, and
zero in the port.) The gradients are read where each side hands them to
`adam_update`: Adam's first step is lr sign(g), so an f16-level difference
in a near-zero gradient would flip a parameter by 2 lr. `adam_update` is
then held on identical gradients to f32 rounding (rtol 1e-6), and a state
saved by the port loads into the JAX package (`_load_state`) array for
array, and back into the port.

Then the densify schedule (`_check_schedule`): the JAX store after the step
(an Adam step on its gradients) carried into the port, the JAX trainer's
host schedule at iterations 2 (densify, capacity growth, filter refresh)
and 3 (opacity reset) against the port's, with the JAX normals for the
splits: the capacities, the densify stats, alive masks, Adam's moments and
the aux buffers exactly, live parameters within rtol 1e-6, atol 1e-7, the
3D filter within rtol 1e-6; and one port step on the grown store.

One test (see test_torch_isolation.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildgaussians_tpu.models.gaussian_store as jgs
import wildgaussians_tpu.models.wildgaussians as jwg
import wildgaussians_tpu.ops.knn_native as jknn_native
from helpers import make_scene
from wildgaussians_tpu.ops.knn import mean_knn_dist2 as jknn
from wildgaussians_tpu.types import new_cameras as jcameras
from wildgaussians_torch import WildGaussians
from wildgaussians_torch.io.convert import state_to_numpy, train_state_from_numpy
import wildgaussians_torch.models.gaussian_store as gs
import wildgaussians_torch.models.wildgaussians as twg
import wildgaussians_torch.ops.blend as tblend
from wildgaussians_torch.types import new_cameras

# a tile budget of 4 (the JAX step's compile and interpret time grow with
# it; 4 takes ~5 s less than 8 on one CPU thread): rects of more tiles are
# truncated, the same way on both sides (`overflow` > 0)
# the densify schedule at its earliest: iteration 2 densifies (and outgrows
# the 640 slots of 591 points), 3 resets the opacities; the compared step
# (iteration 1) does neither
OVERRIDES = dict(uncertainty_mode="disabled", rasterizer_backend="pallas",
                 pallas_pack16=False, num_sky_gaussians=400, max_tiles_per_gaussian=4,
                 densify_from_iter=1, densification_interval=2, opacity_reset_interval=3,
                 initial_capacity=640)
CAMERA, STEP = 1, 0
METRIC_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-3, 5e-2
ADAM_RTOL = 1e-6
# the stores after densify, growth and reset: live parameters (a split
# child's offset may differ by an ulp: XLA's exp and norm round unlike
# PyTorch's) and the 3D filter (a 4x4 inverse through two LAPACK builds)
STORE_RTOL, STORE_ATOL, FILTER_RTOL = 1e-6, 1e-7, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(make_cameras, rng_seed=3, n_cams=3, width=64, height=48, n_points=300):
    rng = np.random.default_rng(rng_seed)
    scene = make_scene(rng, n=n_points, spread=1.5, z_range=(3.0, 7.0))
    poses = []
    for i in range(n_cams):
        angle = (i - n_cams / 2) * 0.08
        pose = np.eye(4, dtype=np.float32)[:3]
        pose[0, 3] = np.sin(angle) * 4.0
        pose[2, 3] = 5.0 - np.cos(angle) * 5.0
        c, s = np.cos(angle * 0.5), np.sin(angle * 0.5)
        pose[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
        poses.append(pose)
    f = width / (2 * np.tan(np.radians(50.0) / 2))
    cams = make_cameras(poses=np.stack(poses),
                        intrinsics=np.array([[f, f, width / 2, height / 2]] * n_cams, np.float32),
                        camera_models=np.zeros((n_cams,), np.int32),
                        distortion_parameters=np.zeros((n_cams, 6), np.float32),
                        image_sizes=np.array([[width, height]] * n_cams, np.int32))
    images = [rng.integers(0, 256, (height, width, 3)).astype(np.uint8) for _ in range(n_cams)]
    masks = [np.where(rng.uniform(size=(height, width)) < 0.8, 255, 0).astype(np.uint8)
             for _ in range(n_cams)]
    return dict(cameras=cams, images=images, masks=masks, points3D_xyz=scene["xyz"],
                points3D_rgb=(scene["colors"] * 255).astype(np.uint8),
                image_paths=[f"{i:03d}.png" for i in range(n_cams)], image_paths_root=".",
                mask_paths=None, mask_paths_root=None, metadata={},
                images_points3D_indices=None)


def _jax_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _port_layout(name, x):
    """A JAX-layout array of `name` in the port's layout (MLP weights [out, in])."""
    return x.T if name.startswith("appearance_mlp/w") else x


def _f16_rows(blend_backward):
    """K2 with its rows rounded as the JAX exact mode rounds them."""
    def rounded(*args, **kwargs):
        rows = blend_backward(*args, **kwargs)
        return torch.clamp(rows, -65504.0, 65504.0).half().float()
    return rounded


def _close(got, want, what):
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL * scale, rtol=GRAD_RTOL, err_msg=what)


def _check_adam(jparams, grads, model):
    """Both `adam_update`s on the same parameters and numpy gradients."""
    lr_iter = 7
    jp = {k: jnp.asarray(v) for k, v in jparams.items()}
    jgrads = {k: jnp.asarray(v) for k, v in grads.items()}
    # moments of an earlier step: mu = g / 2, nu = g^2
    mu0 = {k: 0.5 * v for k, v in grads.items()}
    nu0 = {k: np.square(v) for k, v in grads.items()}
    jstate = jgs.AdamState(*[{k: jnp.asarray(v) for k, v in m.items()}
                             for m in (mu0, nu0)], step=jnp.asarray(3, jnp.int32))
    wd = {"appearance_embeddings": 0.01}
    # nest the MLP as the JAX store does
    def nest(d):
        out = {k: v for k, v in d.items() if "/" not in k}
        out["appearance_mlp"] = {k.split("/")[1]: v for k, v in d.items() if "/" in k}
        return out
    jlrs = jgs.param_learning_rates(model.config, model.spatial_lr_scale, jnp.float32(lr_iter))
    jnew, jad = _ADAM[0](nest(jp), nest(jgrads),
                         jgs.AdamState(nest(jstate.mu), nest(jstate.nu), jstate.step), jlrs,
                         weight_decay=wd)
    tp = {k: torch.tensor(_port_layout(k, v)).contiguous() for k, v in jparams.items()}
    tstate = gs.AdamState(*[{k: torch.tensor(_port_layout(k, v)).contiguous()
                             for k, v in m.items()} for m in (mu0, nu0)],
                          torch.tensor(3, dtype=torch.int32))
    tstate = _ADAM[1](tp, {k: torch.tensor(_port_layout(k, v)).contiguous()
                           for k, v in grads.items()}, tstate,
                      gs.param_learning_rates(model.config, model.spatial_lr_scale, lr_iter),
                      weight_decay=wd)
    assert int(tstate.step) == int(jad.step) == 4
    for got, want in ((tp, jnew), (tstate.mu, jad.mu), (tstate.nu, jad.nu)):
        want = _jax_flat(want)
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), _port_layout(k, want[k]), rtol=ADAM_RTOL,
                                       atol=0, err_msg=f"adam {k}")


_ADAM = (jgs.adam_update, gs.adam_update)


def _store_of(model, jax_side):
    """(params by store key in the port's layout, mu, nu, aux) as numpy."""
    if jax_side:
        flat = model._state_dict()
    else:
        flat = state_to_numpy(model.params, model.mlp, model.aux, model.adam,
                              model.spatial_lr_scale)
    def part(prefix):
        return {k[len(prefix):]: _port_layout(k[len(prefix):], v) for k, v in flat.items()
                if k.startswith(prefix)}
    return part("params/"), part("adam/mu/"), part("adam/nu/"), part("aux/")


def _compare_stores(jm, tm, label):
    jp, jmu, jnu, jaux = _store_of(jm, True)
    tp, tmu, tnu, taux = _store_of(tm, False)
    alive = jaux["alive"]
    assert np.array_equal(taux["alive"], alive), label
    for k, v in jp.items():
        assert tp[k].shape == v.shape, f"{label}: {k}"
        if v.shape[0] == alive.shape[0]:
            got, want = tp[k][alive], v[alive]
        else:
            got, want = tp[k], v
        np.testing.assert_allclose(got, want, rtol=STORE_RTOL, atol=STORE_ATOL,
                                   err_msg=f"{label}: {k}")
    for got, want in ((tmu, jmu), (tnu, jnu)):
        for k, v in want.items():
            assert np.array_equal(got[k], v), f"{label}: Adam {k}"
    for k, v in jaux.items():
        if k == "filter_3D":
            np.testing.assert_allclose(taux[k][alive], v[alive], rtol=FILTER_RTOL, atol=0,
                                       err_msg=f"{label}: {k}")
        else:
            assert np.array_equal(taux[k], v), f"{label}: {k}"


def _check_schedule(monkeypatch, jm, jparams0, tm):
    """From the JAX store after the compared step (an Adam step on its
    gradients), carried into the port by `train_state_from_numpy`: the JAX
    trainer's host schedule at iterations 2 and 3 (`_densify_fn` with its
    next key, `_maybe_grow_capacity`, `_refresh_filter`,
    `_reset_opacity_fn`) against the port's `_densify_schedule`, which draws
    the JAX normals; then one port step on the grown store. (Size pruning,
    from the first densify after a reset on, is held in
    test_torch_densify.py.)"""
    config = tm.config
    grads = jax.tree_util.tree_map(lambda g: jnp.nan_to_num(g), jm.params)
    wd = {"appearance_embeddings": config.appearance_embedding_regularization}
    jm.params, jm.adam = _ADAM[0](
        jax.tree_util.tree_map(jnp.asarray, jparams0), grads, jm.adam,
        jgs.param_learning_rates(jm.config, jm.spatial_lr_scale, jnp.float32(STEP + 1)),
        weight_decay=wd)
    state = train_state_from_numpy(jm._state_dict(), config)
    (tm.params, tm.mlp, tm.aux), tm.adam = state.model, state.adam
    for t in tm._trainable().values():
        t.requires_grad_(True)
    _compare_stores(jm, tm, "carried")
    port_stats = []

    def densify(*args, **kwargs):
        out = _DENSIFY(*args, **kwargs)
        port_stats.append({k: int(v) for k, v in out[3].items()})
        return out
    monkeypatch.setattr(gs, "densify_and_prune", densify)
    capacities = [jm.aux.alive.shape[0]]
    for iteration in (2, 3):
        jstats = None
        if iteration % config.densification_interval == 0:
            jm._key, sub = jax.random.split(jm._key)
            c = jm.aux.alive.shape[0]
            normals = tuple(torch.tensor(np.asarray(jax.random.normal(k, (c, 3))))
                            for k in (sub, jax.random.fold_in(sub, 1)))
            monkeypatch.setattr(gs, "split_normals", lambda _c, _g, normals=normals: normals)
            jm.params, jm.adam, jm.aux, dstats = jm._densify_fn(
                sub, jm.params, jm.adam, jm.aux, jnp.float32(jm.cameras_extent),
                jnp.bool_(iteration > config.opacity_reset_interval))
            jstats = {k: int(v) for k, v in dstats.items()}
            jm._maybe_grow_capacity(dstats)
            jm._refresh_filter()
        if iteration % config.opacity_reset_interval == 0:
            jm.params, jm.adam = jm._reset_opacity_fn(jm.params, jm.adam, jm.aux)
        tm._densify_schedule(iteration, True)
        if jstats is not None:
            assert port_stats.pop() == jstats, f"iteration {iteration}: {jstats}"
        capacities.append(jm.aux.alive.shape[0])
        assert tm.aux.alive.shape[0] == capacities[-1], f"iteration {iteration}"
        _compare_stores(jm, tm, f"after iteration {iteration}")
    assert capacities[1] > capacities[0], "iteration 2 grows the store"
    # one step of the port on the grown store
    monkeypatch.setattr(gs, "adam_update", _ADAM[1])
    metrics = tm.train_iteration(4, camera_id=CAMERA)
    assert np.isfinite(metrics["loss"]) and metrics["num_gaussians"] == int(tm.aux.alive.sum())


_DENSIFY = gs.densify_and_prune


def test_train_step_matches_jax(monkeypatch, tmp_path):
    # both sides get one array of Morton-window 3-NN distances (the JAX
    # package's fallback, which needs no g++), so that the step compares the
    # render, the loss and the gradients alone; test_torch_knn_native.py and
    # test_torch_train_init.py hold the port's k-NN against the JAX default
    monkeypatch.setattr(jknn_native, "available", lambda: False)
    monkeypatch.setattr(twg, "mean_knn_dist2",
                        lambda t: torch.as_tensor(np.asarray(jknn(jnp.asarray(t.numpy())))))
    jm = jwg.WildGaussians(train_dataset=_dataset(jcameras), config_overrides=dict(OVERRIDES))
    tds = _dataset(new_cameras)
    tm = WildGaussians(train_dataset=tds, config_overrides=dict(OVERRIDES), device="cpu")
    jflat = _jax_flat(jm.params)
    tflat = {k: v.detach().numpy() for k, v in tm._trainable().items()}
    assert sorted(jflat) == sorted(tflat)
    for k, v in tflat.items():
        assert np.array_equal(v, _port_layout(k, jflat[k])), f"initial {k}"
    # SH degree 3 from the first step, so that features_rest gets gradient,
    # and anisotropic Gaussians, so that the rotations do (an initial
    # Gaussian is a sphere, whose covariance no rotation changes)
    jm.aux = jm.aux._replace(active_sh_degree=jnp.int32(3))
    tm.aux = tm.aux._replace(active_sh_degree=torch.tensor(3, dtype=torch.int32))
    rng = np.random.default_rng(0)
    for k, sigma in (("scales", 0.3), ("rotations", 0.2)):
        v = (tflat[k] + rng.normal(0, sigma, tflat[k].shape)).astype(np.float32)
        jm.params[k] = jnp.asarray(v)
        with torch.no_grad():
            tm.params[k].copy_(torch.tensor(v))
        tflat[k] = v

    # each side's gradients, read where its step hands them to Adam (the
    # JAX step then keeps them as its "parameters")
    captured = {}

    def t_capture(params, grads, state, lrs, weight_decay=None):
        captured.update({k: g.detach().clone() for k, g in grads.items()})
        return state
    monkeypatch.setattr(jgs, "adam_update", lambda p, g, s, lrs, weight_decay=None: (g, s))
    monkeypatch.setattr(gs, "adam_update", t_capture)
    monkeypatch.setattr(tblend, "blend_backward", _f16_rows(tblend.blend_backward))
    # the JAX step donates its store: keep the parameters it started from
    jparams0 = jax.tree_util.tree_map(np.asarray, jm.params)
    jmetrics = jm.train_iteration(STEP, camera_id=CAMERA)
    tmetrics = tm.train_iteration(STEP, camera_id=CAMERA)

    assert set(tmetrics) <= set(jmetrics) and "psnr_masked" in tmetrics
    for k, v in tmetrics.items():
        np.testing.assert_allclose(v, jmetrics[k], rtol=METRIC_RTOL, err_msg=k)
    assert tmetrics["overflow"] > 0 and tmetrics["num_rendered"] > 0
    jgrads = _jax_flat(jm.params)
    alive = tm.aux.alive.numpy()
    for k, g in captured.items():
        want, got = _port_layout(k, jgrads[k]), g.numpy()
        if want.shape[0] == alive.shape[0]:
            want, got = want[alive], got[alive]
        assert np.abs(want).max() > 0, f"{k} has no gradient"
        _close(got, want, f"gradient of {k}")
    for field in ("xyz_grad", "xyz_gradient_accum_abs", "xyz_gradient_accum_abs_max"):
        want = np.asarray(getattr(jm.aux, field))
        assert want.max() > 0, field
        _close(getattr(tm.aux, field).numpy(), want, field)
    for field in ("denom", "max_radii2D", "alive", "active_sh_degree"):
        assert np.array_equal(getattr(tm.aux, field).numpy(), np.asarray(getattr(jm.aux, field))), field

    # Adam on identical gradients
    _check_adam(tflat, {k: _port_layout(k, np.nan_to_num(v)) for k, v in jgrads.items()}, tm)

    # a port checkpoint (after a real Adam step) loads into the JAX package
    trainable = tm._trainable()
    tm.adam = _ADAM[1](trainable, captured, tm.adam,
                       gs.param_learning_rates(tm.config, tm.spatial_lr_scale, 1))
    tm.save(str(tmp_path))
    loaded = jwg.WildGaussians(checkpoint=str(tmp_path))
    assert loaded.step == tm.step == STEP + 1
    assert loaded.spatial_lr_scale == tm.spatial_lr_scale
    for k, v in _jax_flat(loaded.params).items():
        assert np.array_equal(_port_layout(k, v), trainable[k].detach().numpy()), k
    for which in ("mu", "nu"):
        for k, v in _jax_flat(getattr(loaded.adam, which)).items():
            assert np.array_equal(_port_layout(k, v), getattr(tm.adam, which)[k].numpy()), k
    assert int(loaded.adam.step) == int(tm.adam.step) == 1
    for field in jgs.AuxState._fields:
        assert np.array_equal(np.asarray(getattr(loaded.aux, field)),
                              getattr(tm.aux, field).numpy()), field
    # and resumes in the port
    resumed = WildGaussians(checkpoint=str(tmp_path), train_dataset=tds, device="cpu")
    for k, v in resumed._trainable().items():
        assert np.array_equal(v.detach().numpy(), trainable[k].detach().numpy()), k
    assert int(resumed.adam.step) == 1 and resumed.step == STEP + 1

    _check_schedule(monkeypatch, jm, jparams0, tm)
