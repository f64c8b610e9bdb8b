"""`optimize_embedding` of the port's `WildGaussians` against the JAX
package's, on a seeded 70x45 model (a `helpers.make_scene` point cloud with
sky points, SH degree 3, appearance on, an occluder mask on the image), the
JAX side with `rasterizer_backend="pallas"`, `pallas_pack16=False` (its
Pallas kernels in interpret mode), both with the uncertainty model disabled.
The port's model is the JAX model's checkpoint, loaded through
`WildGaussians(checkpoint=...)`. The fitted image is the left half that each
package's `horizontal_half_dataset` cuts, as the NeRF-W protocol fits it:
35x45, neither side a multiple of 16, so the render runs on a 48x48 canvas
clipped to `actual_size`.

Checked, for 3 iterations of the loss "dssim+l1-scaled" (the default; the
scaling needs the uncertainty model, so only the mask scales the
gradients):
- the loss and mse of each iteration within rtol 1e-4;
- the first iteration's embedding gradient within the train-step test's
  gradient tolerance (atol 5e-3 max|g|, rtol 5e-2; the JAX side rounds its
  per-entry gradient rows to f16), the JAX gradient read from Adam's first
  moment after one `_embed_opt_step` (mu = 0.1 g);
- the final embedding within atol EMB_ATOL (each Adam step moves a
  component by up to lr = 0.1; an f16-level difference in a gradient moves
  it by far less);
- `render_internal(return_raw=False)` (the toned pass alone) of the half
  camera on its clipped canvas equal to the JAX package's at the render
  test's tolerance (atol 1e-4), and not equal to the raw pass.

One test (see test_torch_isolation.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildgaussians_tpu.models.gaussian_store as jgs
import wildgaussians_tpu.models.wildgaussians as jwg
from helpers import make_scene
from wildgaussians_tpu.datasets.phototourism import horizontal_half_dataset as jhalf
from wildgaussians_tpu.models.renderer import render_internal as jrender_internal
from wildgaussians_tpu.types import new_cameras as jcameras
from wildgaussians_torch import WildGaussians
from wildgaussians_torch.datasets.phototourism import horizontal_half_dataset as thalf
from wildgaussians_torch.models import gaussian_store as gs
from wildgaussians_torch.models.renderer import render_internal
from wildgaussians_torch.types import new_cameras

OVERRIDES = dict(uncertainty_mode="disabled", rasterizer_backend="pallas",
                 pallas_pack16=False, num_sky_gaussians=100, max_tiles_per_gaussian=4,
                 appearance_embedding_optim_iters=3)
# the training images; the fitted left half is 35x45 on a 48x48 canvas
WIDTH, HEIGHT = 70, 45
CANVAS = 48
LOSS_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-3, 5e-2
EMB_ATOL = 1e-3
RENDER_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread (the suite runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _datasets(n_cams=3, n_points=300):
    """The same training set for both packages (their own Cameras types)."""
    rng = np.random.default_rng(5)
    scene = make_scene(rng, n=n_points, spread=1.5, z_range=(3.0, 7.0))
    poses = []
    for i in range(n_cams):
        angle = (i - n_cams / 2) * 0.08
        pose = np.eye(4, dtype=np.float32)[:3]
        pose[0, 3] = np.sin(angle) * 4.0
        c, s = np.cos(angle * 0.5), np.sin(angle * 0.5)
        pose[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
        poses.append(pose)
    f = WIDTH / (2 * np.tan(np.radians(50.0) / 2))
    cams = dict(poses=np.stack(poses),
                intrinsics=np.array([[f, f, WIDTH / 2, HEIGHT / 2]] * n_cams, np.float32),
                camera_models=np.zeros((n_cams,), np.int32),
                distortion_parameters=np.zeros((n_cams, 6), np.float32),
                image_sizes=np.array([[WIDTH, HEIGHT]] * n_cams, np.int32))
    images = [rng.integers(0, 256, (HEIGHT, WIDTH, 3)).astype(np.uint8) for _ in range(n_cams)]
    masks = [np.where(rng.uniform(size=(HEIGHT, WIDTH)) < 0.8, 255, 0).astype(np.uint8)
             for _ in range(n_cams)]
    out = []
    for make in (jcameras, new_cameras):
        out.append(dict(cameras=make(**cams), images=images, masks=masks,
                        points3D_xyz=scene["xyz"],
                        points3D_rgb=(scene["colors"] * 255).astype(np.uint8),
                        image_paths=[f"{i:03d}.png" for i in range(n_cams)],
                        image_paths_root=".", mask_paths=None, mask_paths_root=None,
                        metadata={}, images_points3D_indices=None))
    return out


def _one(ds, i):
    """The dataset of camera i alone."""
    return dict(ds, cameras=ds["cameras"][i:i + 1], images=[ds["images"][i]],
                masks=[ds["masks"][i]], image_paths=[ds["image_paths"][i]])


def _jax_first_gradient(jm, one):
    """The JAX embedding gradient of the first iteration: one
    `_embed_opt_step` from zeros, read from Adam's first moment (mu = 0.1 g).
    Its arguments as `optimize_embedding` passes them (the canvas size
    positionally), so the step compiled there is reused."""
    cam = one["cameras"].item()
    w, h = (int(x) for x in cam.image_sizes)
    gt = jnp.asarray(jwg._pad_to(one["images"][0].astype(np.float32) / 255.0, CANVAS, CANVAS))
    pixmask = jnp.asarray(jwg._pad_to(np.ones((h, w, 1), np.float32), CANVAS, CANVAS)[..., 0])
    mult = jnp.asarray(jwg._pad_to(one["masks"][0].astype(np.float32)[..., None] / 255.0,
                                   CANVAS, CANVAS)[..., 0])
    emb = jm.get_embedding(None)
    _e, mu, _nu, _t, _l, _m = jm._embed_opt_step(
        emb, jnp.zeros_like(emb), jnp.zeros_like(emb), jnp.int32(0), jm.params, jm.aux,
        jnp.asarray(cam.poses, jnp.float32), jnp.asarray(cam.intrinsics, jnp.float32),
        (jnp.float32(w), jnp.float32(h)), gt, pixmask, mult, CANVAS, CANVAS)
    return np.asarray(mu) / np.float32(0.1)


def _renders_no_raw(jm, tm, one_t):
    """render_internal(return_raw=False) on the half camera at a trained
    embedding, on its clipped canvas, both packages; and the port's raw
    pass."""
    emb = np.asarray(jm.params["appearance_embeddings"][2])
    cam = one_t["cameras"].item()
    w, h = (int(x) for x in cam.image_sizes)
    pose = np.asarray(cam.poses, np.float32)
    intr = np.asarray(cam.intrinsics, np.float32)
    config = jm.config

    def run(params, aux, pose, intr, emb):
        g = jgs.get_gaussians(params, aux, config)
        pkg = jrender_internal(g, params, aux.active_sh_degree, aux.alive, config, pose, intr,
                               CANVAS, CANVAS, embedding=emb, kernel_size=config.kernel_size,
                               return_raw=False, actual_size=(w, h))
        return pkg.render, pkg.raw_render, pkg.accumulation
    j_img, j_raw, j_acc = jax.jit(run)(jm.params, jm.aux, jnp.asarray(pose), jnp.asarray(intr),
                                       jnp.asarray(emb))
    with torch.no_grad():
        g = gs.get_gaussians(tm.params, tm.aux)
        args = (g, tm.params, tm.mlp, tm.aux.active_sh_degree, tm.aux.alive, tm.config,
                torch.as_tensor(pose), torch.as_tensor(intr), CANVAS, CANVAS)
        kw = dict(embedding=torch.as_tensor(emb), kernel_size=tm.config.kernel_size,
                  actual_size=(float(w), float(h)))
        toned = render_internal(*args, return_raw=False, **kw)
        both = render_internal(*args, **kw)
    np.testing.assert_allclose(np.asarray(j_raw), np.asarray(j_img))   # one pass in JAX too
    np.testing.assert_allclose(toned.render.numpy(), np.asarray(j_img), atol=RENDER_ATOL, rtol=0)
    np.testing.assert_allclose(toned.raw_render.numpy(), toned.render.numpy())
    np.testing.assert_allclose(toned.accumulation.numpy(), np.asarray(j_acc),
                               atol=RENDER_ATOL, rtol=0)
    np.testing.assert_allclose(both.render.numpy(), toned.render.numpy(), atol=1e-6)
    assert np.abs(both.raw_render.numpy() - toned.render.numpy()).max() > 1e-2


def test_optimize_embedding_matches_jax(tmp_path):
    jds, tds = _datasets()
    jm = jwg.WildGaussians(train_dataset=jds, config_overrides=OVERRIDES)
    # a trained-looking model: every camera's embedding and the active SH
    # degree away from their initial values
    rng = np.random.default_rng(1)
    emb = jm.params["appearance_embeddings"]
    jm.params["appearance_embeddings"] = emb + jnp.asarray(
        rng.normal(0, 0.5, emb.shape).astype(np.float32))
    jm.aux = jm.aux._replace(active_sh_degree=jnp.int32(3))
    jm.save(str(tmp_path / "ckpt"))
    tm = WildGaussians(checkpoint=str(tmp_path / "ckpt"), device="cpu")

    j_one, t_one = jhalf(_one(jds, 1), left=True), thalf(_one(tds, 1), left=True)
    assert [tuple(x) for x in t_one["cameras"].image_sizes] == [(35, HEIGHT)]
    j_out = jm.optimize_embedding(j_one)
    t_out = tm.optimize_embedding(t_one)
    for k in ("loss", "mse"):
        np.testing.assert_allclose(t_out["metrics"][k], j_out["metrics"][k], rtol=LOSS_RTOL,
                                   err_msg=k)
    assert len(t_out["metrics"]["psnr"]) == OVERRIDES["appearance_embedding_optim_iters"]
    np.testing.assert_allclose(t_out["embedding"], j_out["embedding"], atol=EMB_ATOL, rtol=0)
    assert np.abs(t_out["embedding"]).max() > 0.1     # it moved

    j_grad = _jax_first_gradient(jm, j_one)
    inputs = tm._embed_opt_inputs(t_one)
    with torch.no_grad():
        gaussians = gs.get_gaussians(tm.params, tm.aux)
    var = tm.get_embedding(None).clone().requires_grad_(True)
    loss, _mse = tm._embed_opt_loss(gaussians, var, *inputs)
    (t_grad,) = torch.autograd.grad(loss, [var])
    scale = np.abs(j_grad).max()
    assert scale > 0
    np.testing.assert_allclose(t_grad.numpy(), j_grad, atol=GRAD_ATOL * scale, rtol=GRAD_RTOL)

    _renders_no_raw(jm, tm, t_one)
