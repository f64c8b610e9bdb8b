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

One test (see test_torch_isolation.py)."""
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
import wildgaussians_torch.models.gaussian_store as gs
import wildgaussians_torch.models.wildgaussians as twg
import wildgaussians_torch.ops.blend as tblend
from wildgaussians_torch.types import new_cameras

# a tile budget of 4 (the JAX step's compile and interpret time grow with
# it; 4 takes ~5 s less than 8 on one CPU thread): rects of more tiles are
# truncated, the same way on both sides (`overflow` > 0)
OVERRIDES = dict(uncertainty_mode="disabled", rasterizer_backend="pallas",
                 pallas_pack16=False, num_sky_gaussians=400, max_tiles_per_gaussian=4)
CAMERA, STEP = 1, 0
METRIC_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-3, 5e-2
ADAM_RTOL = 1e-6


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
